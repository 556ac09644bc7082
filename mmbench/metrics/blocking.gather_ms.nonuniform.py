"""Device milliseconds per product in the nonuniform blocking's gathers
(the program's spans ``blocking.expand`` and ``blocking.compact``)."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("blocking.",), "device_s")
