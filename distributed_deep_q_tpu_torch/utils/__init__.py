"""Subpackage of the PyTorch/CUDA port."""
