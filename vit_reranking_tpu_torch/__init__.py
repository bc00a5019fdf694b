"""PyTorch/CUDA port of vit_reranking_tpu for NVIDIA Hopper.

Sub-packages mirror the JAX package (``core/ data/ models/ ops/ engine/
cli/``); the hand-written CUDA kernels live in ``csrc/`` and are built by
``ops/native.py`` on first use.  Nothing here imports JAX.
"""
