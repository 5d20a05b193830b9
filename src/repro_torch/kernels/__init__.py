"""Hand-written CUDA kernels for Hopper, each behind a wrapper that runs
its plain PyTorch version (``kernels.ref``) on CPU tensors."""
