"""``device.idle`` in the rank cells, where it moves ``useful_tflops.rank``."""
from mmbench.metrics import reader

read = reader("device.idle")
