"""Device milliseconds per product in copying the factor layout to the card
(the program's spans ``rank.upload``)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("rank.upload",), "device_s")
