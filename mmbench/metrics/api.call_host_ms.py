"""Host milliseconds inside each ``__call__`` of the program's entry point
(front-end and planner, and whatever the call waits for), as the mean per
product, by the benchmark's clock around the call."""


def read(view):
    return 1e3 * sum(view.call_host_s) / view.products
