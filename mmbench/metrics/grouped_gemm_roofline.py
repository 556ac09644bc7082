"""``grouped_gemm``'s share (%) of its least time for the product's rank
count (``count``: each live block's V at its true rank times its panel of
B), over its device time from the profiler."""


def read(view):
    return view.roofline("grouped_gemm")
