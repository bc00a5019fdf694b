"""Thin entry point over cli/test_diml.py (reference test_diml_base.py),
the one scripts/diml/test_diml.sh runs on a ResNet-50:

    python -m vit_reranking_tpu_torch.cli.test_diml_base --dataset cub200 \
        --arch resnet50_frozen_normalize --embed_dim 128 --grid_size 4 \
        --use_uniform --bs 16 --resume_path RUN/best
"""

from .test_diml import main

if __name__ == "__main__":
    main()
