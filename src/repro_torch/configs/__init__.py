"""configs package of the PyTorch/CUDA port."""
