"""MSDA: the plain PyTorch version and the CUDA kernel's wrapper."""
