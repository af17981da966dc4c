"""Hand-written Hopper kernels: wrappers, plain PyTorch twins, launch counters."""
