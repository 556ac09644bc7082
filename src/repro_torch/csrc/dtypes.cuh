// dtype codes of the kernels' C interfaces, shared with the Python
// wrappers (kernels/_build.py::dtype_code)
#pragma once

namespace repro_torch {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace repro_torch
