"""``tiled_matmul``'s share (%) of its least time at its calls' own shapes
(``count``), over its device time from the profiler."""


def read(view):
    return view.roofline("tiled_matmul")
