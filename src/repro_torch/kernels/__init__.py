"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version: ``tiled_matmul``, ``bsmm``, ``grouped_gemm`` and
``flash_attention``; ``ops`` holds the wrappers the engine and the model
call."""
