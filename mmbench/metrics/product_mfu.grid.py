"""Useful FLOP/s of the whole product as a share (%) of the peak of every
card it spans (``view.cards`` times ``count.PEAKS``): the grid's work
against the grid's peak, at the window's median product.  The median,
since a traced run profiles a stretch of the window, and the profiler
slows the host that paces the product and stalls it when it starts and
stops."""
import statistics


def read(view):
    if not view.peak or not view.product_s:
        return None
    flop = view.useful_flop / view.products
    return 100.0 * flop / statistics.median(view.product_s) / (
        view.cards * view.peak["flops"])
