"""``bsmm``'s share (%) of its least time for the product's useful triples
(``count``), over its device time from the profiler."""


def read(view):
    return view.roofline("bsmm")
