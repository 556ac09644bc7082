"""``bsmm_roofline`` in the grid cells: rank 0's ``bsmm`` device time over
the traced products against rank 0's own share of the useful work (the
route's ``kernel_work``), where it moves ``useful_tflops.grid``."""
from mmbench import count
from mmbench.run import KERNELS


def read(view):
    if view.trace is None or not view.trace.calls:
        return None
    work = view.kernel_work.get("bsmm")
    t = view.program_device_s(KERNELS["bsmm"])
    if not work or not view.peak or not t:
        return None
    return 100.0 * count.least_seconds(*work, view.peak) * len(
        view.trace.calls) / t
