"""core sub-package of the PyTorch/CUDA port."""
