"""repro_torch — the PyTorch/CUDA port of ``repro``, task-based SUMMA.

A second package beside the JAX reference ``repro``, mirroring it module
for module (``repro_torch/core/plan.py`` is the port of
``repro/core/plan.py``, and so on).  It imports ``torch`` and never
``jax`` nor ``repro``.  Ported so far: the matmul engine's main path —
``DistributedMatmul`` -> ``plan_matmul`` -> ``execute_plan`` — dense and
block-sparse, with the reference's two Pallas kernels on that path
(``tiled_matmul``, ``bsmm``) rewritten as CUDA kernels for Hopper.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
from repro_torch.core import (
    DistributedMatmul,
    Grid,
    MatmulPlan,
    SummaConfig,
    execute_plan,
    plan_matmul,
)

__all__ = [
    "DistributedMatmul",
    "Grid",
    "MatmulPlan",
    "SummaConfig",
    "execute_plan",
    "plan_matmul",
]
