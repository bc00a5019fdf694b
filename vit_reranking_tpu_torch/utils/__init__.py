"""utils sub-package of the PyTorch/CUDA port."""
