"""Hand-written CUDA kernels, each with its plain PyTorch twin and a wrapper
that launches the kernel for CUDA tensors and runs the twin for CPU ones."""
