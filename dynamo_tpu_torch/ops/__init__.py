"""Plain PyTorch attention (ops/attention.py) and the CUDA kernels (ops/cuda/)."""
