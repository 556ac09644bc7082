"""Core: task-based SUMMA for block-sparse tensor computing (the paper)."""
from repro_torch.core.api import (
    DistributedMatmul,
    NonuniformMatmul,
    pad_to_multiple,
)
from repro_torch.core.contract import (
    BlockSparseTensor,
    ContractionSpec,
    contract,
    contract_chain,
    parse_contraction,
)
from repro_torch.core.grid import Grid
from repro_torch.core.plan import (
    MatmulPlan,
    PlanCost,
    mask_key,
    plan_matmul,
    rank_key,
)
from repro_torch.core.sparsity import (
    BlockCSR,
    BlockRankMap,
    RankCSR,
    banded_block_mask,
    block_csr_from_mask,
    block_diag_block_mask,
    block_rank_flops,
    decay_block_mask,
    decay_rank_map,
    mask_matmul_flops,
    random_block_mask,
    random_rank_map,
    rank_csr_from_dense,
    rank_matmul_flops,
    synthesize_rank_csr,
)
from repro_torch.core.blocking import (
    BucketedTiling,
    LoadStats,
    Tiling,
    bucketize,
    cyclic_owner,
    load_stats,
    nonuniform_tiling,
    paper_nonuniform_sizes,
    uniform_tiling,
)
from repro_torch.core.summa import (
    SummaConfig,
    clear_executable_cache,
    executable_cache_stats,
    execute_plan,
    execute_rank_plan,
    multi_issue_limit,
    rank_operands,
    reference_blocksparse_matmul,
    reference_matmul,
    reference_ranksparse_matmul,
    resolve_multi_issue,
    summa_25d_matmul,
    summa_blocksparse_matmul,
    summa_matmul,
    warm_plan_executable,
)
