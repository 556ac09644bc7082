"""Device milliseconds per product in gathering the live panels for
``bsmm`` (the program's spans ``exec.panels``: the broadcasts and the two
``torch.cat``)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("exec.panels",), "device_s")
