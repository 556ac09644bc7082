"""Device milliseconds per product in the rank route's stage 2: the U
panels' concatenation, the batched product and its add into C (the
program's spans ``rank.stage2``)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("rank.stage2",), "device_s")
