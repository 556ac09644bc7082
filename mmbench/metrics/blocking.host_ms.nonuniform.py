"""Host milliseconds per product in the nonuniform blocking's gathers (the
program's spans ``blocking.expand`` and ``blocking.compact``): where the
host waits on the card inside the call."""
from mmbench import spans


def read(view):
    return spans.per_product_ms(view, ("blocking.",), "host_s")
