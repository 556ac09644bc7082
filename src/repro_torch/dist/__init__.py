"""Parallelism policy (``context.ParallelCtx``) and the projections that
carry the paper's engine into the LM (``collective_matmul.project``)."""
from repro_torch.dist.context import ParallelCtx

__all__ = ["ParallelCtx"]
