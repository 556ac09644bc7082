"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version; ``ops`` holds the wrappers the engine calls."""
