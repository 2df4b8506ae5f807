"""Kernel names of the arc-sharded solve, shared by the metrics that read
them: K7 (``csrc/kkt_shard_matvec.cu``) and NCCL's kernels."""

from __future__ import annotations

from h100_bench import trace

SHARD_MATVEC = trace.name_has("kkt_shard_matvec_kernel")
NCCL = trace.name_has("nccl")
