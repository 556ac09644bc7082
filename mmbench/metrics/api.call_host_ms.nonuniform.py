"""``api.call_host_ms`` in the nonuniform cells, where it moves ``useful_tflops.nonuniform``."""
from mmbench.metrics import reader

read = reader("api.call_host_ms")
