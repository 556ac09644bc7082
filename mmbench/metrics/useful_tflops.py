"""Useful TFLOP/s: the frozen count of every product in the window over
the window's host-clock time."""


def read(view):
    return view.useful_flop / view.window_s / 1e12
