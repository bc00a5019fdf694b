"""Thin entry point over cli.test_diml (reference test_diml_swin.py): Swin-T
reranked by featvit from its head-projected 7x7 token map, as
scripts/diml/test_diml_swin.sh runs it."""

from .test_diml import main

if __name__ == "__main__":
    main()
