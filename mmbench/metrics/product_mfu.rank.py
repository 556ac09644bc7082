"""``product_mfu`` in the rank cells, where it moves ``useful_tflops.rank``."""
from mmbench.metrics import reader

read = reader("product_mfu")
