"""Device milliseconds per product in the program's calls outside its four
hand-written kernels: masking, the adds into C, zero-fills, copies and the
padding gathers, by kernel name from the profiler."""

EXCLUDE = ("tiled_matmul_kernel", "bsmm_kernel", "grouped_gemm_kernel",
           "fa_wgmma_kernel", "fa_fma_kernel")


def read(view):
    s = view.program_device_s(exclude=EXCLUDE)
    return None if s is None else 1e3 * s / view.products
