"""Peak device memory over the window (GiB), the resident operands in it:
``torch.cuda.max_memory_allocated()`` after a reset at the window's start."""


def read(view):
    return view.peak_bytes / 2**30
