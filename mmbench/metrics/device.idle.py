"""The share (%) of the traced window in which no kernel, copy or fill ran
on the card."""


def read(view):
    busy, window = view.busy_s(), view.traced_window_s()
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
