"""``executor.aux_ms`` in the nonuniform cells, where it moves ``useful_tflops.nonuniform``."""
from mmbench.metrics import reader

read = reader("executor.aux_ms")
