"""``product_mfu`` in the nonuniform cells, where it moves ``useful_tflops.nonuniform``."""
from mmbench.metrics import reader

read = reader("product_mfu")
