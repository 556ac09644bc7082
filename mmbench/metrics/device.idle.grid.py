"""The share (%) of a product in which no kernel, copy or fill runs on
rank 0's card, at the window's own pace: one less the device's busy time
per traced product (the union of its intervals in the profiler's trace)
over the window's median product, which the traced stretch barely moves
(the profiler slows the host that paces the product)."""
import statistics


def read(view):
    busy = view.busy_s()
    if not busy or not view.trace.calls or not view.product_s:
        return None
    per_product = busy / len(view.trace.calls)
    return 100.0 * (1.0 - per_product / statistics.median(view.product_s))
