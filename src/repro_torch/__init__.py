"""repro_torch — the PyTorch/CUDA port of ``repro``, task-based SUMMA.

A second package beside the JAX reference ``repro``, mirroring it module
for module (``repro_torch/core/plan.py`` is the port of
``repro/core/plan.py``, and so on).  It imports ``torch`` and never
``jax`` nor ``repro``.  Ported so far:

* the matmul engine's main path — ``DistributedMatmul`` ->
  ``plan_matmul`` -> ``execute_plan`` — dense and block-sparse, through
  the ``tiled_matmul`` and ``bsmm`` kernels;
* its block-rank-sparse route — ``DistributedMatmul(None, b,
  a_ranks=RankCSR)`` -> ``execute_rank_plan`` — through ``grouped_gemm``;
* the LM forward of the dense-attention family — ``models.model.forward``
  and ``loss_fn`` with ``dist.context.ParallelCtx`` and
  ``dist.collective_matmul.project`` — through ``flash_attention``;
* the paper's scheduler — the task graph, its simulator and the schedule
  tuner (``sched``), which ``tune=True`` and ``matmul_strategy="auto"``
  execute — with the kernel autotune cache (``kernels.autotune``),
  ``NonuniformMatmul`` over ``core.blocking``, and the pull and A-/B-
  stationary routes of mask plans;
* the block-sparse tensor front-end — ``contract``, ``contract_chain``
  and ``BlockSparseTensor`` (``core.contract``) — over the digest-keyed
  executable cache of ``core.summa`` (``compiled=True``);
* the MoE, recurrent and frontend families, serving (``serve``,
  ``launch.serve``) and training (``train``, ``launch.train``, with
  ``models.chunked_attention``).

Each of the reference's four Pallas kernels is a hand-written CUDA kernel
for Hopper (``csrc/``).  Entry points run on ``cuda`` unless the caller
asks for the CPU.
"""
from repro_torch.core import (
    BlockSparseTensor,
    DistributedMatmul,
    Grid,
    MatmulPlan,
    NonuniformMatmul,
    SummaConfig,
    contract,
    contract_chain,
    execute_plan,
    plan_matmul,
)

__all__ = [
    "BlockSparseTensor",
    "DistributedMatmul",
    "Grid",
    "MatmulPlan",
    "NonuniformMatmul",
    "SummaConfig",
    "contract",
    "contract_chain",
    "execute_plan",
    "plan_matmul",
]
