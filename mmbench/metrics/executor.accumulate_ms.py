"""Device milliseconds per product in the adds of the panel products into C
(the program's spans ``exec.accumulate``)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("exec.accumulate",), "device_s")
