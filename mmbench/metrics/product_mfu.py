"""Useful FLOP/s of the traced window as a share (%) of the card's peak
(``count.PEAKS``): the whole product's bound on any kernel's gain."""


def read(view):
    if not view.peak:
        return None
    return 100.0 * view.useful_flop / view.window_s / view.peak["flops"]
