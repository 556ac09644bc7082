"""Device milliseconds per product in the masking of the operands (the
program's spans ``exec.mask``: ``torch.where`` over the block selectors)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("exec.mask",), "device_s")
