"""``executor.aux_ms`` in the rank cells, where it moves ``useful_tflops.rank``."""
from mmbench.metrics import reader

read = reader("executor.aux_ms")
