"""launch package of the PyTorch/CUDA port."""
