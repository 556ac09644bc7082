"""``tiled_matmul_roofline`` in the nonuniform cells, where it moves
``useful_tflops.nonuniform``."""
from mmbench.metrics import reader

read = reader("tiled_matmul_roofline")
