"""Speed-of-light measurement of the streaming KKT matvec, K7.

Counterpart of ``two_pass_lanczos_tpu/utils/sol_bench.py``, which chains
``kkt_streaming_matvec`` (the TPU kernel ``_matvec_streaming_kernel``,
``ops/kkt_fused.py:937``). Its port is K7 (``kkt_shard_matvec_cuda``,
``csrc/kkt_shard_matvec.cu``), timed here on the whole instance as one
shard by the same hi − lo method: two CUDA graphs of ``lo`` and ``hi``
launches, each replayed ``reps`` times and timed by CUDA events, the
minimum of each kept, and per matvec ΔT / (hi − lo), which cancels the
graph launch and the events. The launches are not chained: K7's cost does
not depend on the values, so y = A·x₀ into two alternating outputs does a
chain's work per launch, and no rescaling is needed (an unscaled chain
overflows f32 at these degrees). On the CPU the plain version
(``kkt_shard_matvec``) is timed by the host clock, for the record's shape
only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.observability import (
    H100_SXM_HBM3_BW,
    SoLReport,
    kkt_matvec_bytes,
    kkt_spmv_sol,
)

__all__ = ["ideal_matvec_bytes", "measure_streaming_matvec"]


def ideal_matvec_bytes(num_arcs: int, num_nodes: int) -> int:
    """Bytes the function y = A·x must move, each array once: d, u, v, x_a
    and y_a per arc (20 B), x_n and y_n per node (8 B)."""
    return 20 * num_arcs + 8 * num_nodes


def _graph_sampler(lay, x):
    """``sample(count)``: device seconds of one replay of a CUDA graph of
    ``count`` K7 launches, their outputs alternating between two
    buffers."""
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        kkt_shard_matvec_cuda,
    )

    ys = torch.empty((2, lay.n), dtype=torch.float32, device=x.device)
    graphs = {}

    def capture(count):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                kkt_shard_matvec_cuda(lay, x, out=ys[i])
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(count):
                kkt_shard_matvec_cuda(lay, x, out=ys[i % 2])
        return g

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def sample(count):
        if count not in graphs:
            graphs[count] = capture(count)
            graphs[count].replay()  # warm
        start.record()
        graphs[count].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return sample


def _host_sampler(lay, x):
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import kkt_shard_matvec

    def sample(count):
        t0 = time.perf_counter()
        for _ in range(count):
            kkt_shard_matvec(lay, x)
        return time.perf_counter() - t0

    return sample


def measure_streaming_matvec(arcs: int, rho: int = 3, reps: int = 5,
                             lo: int = 64, hi: int = None,
                             device=DEFAULT_DEVICE):
    """Return ``(seconds_per_matvec, SoLReport_layout, SoLReport_ideal,
    meta)`` for ``generate_mcf_instance(arcs, rho, instance_id=1)``:
    the layout report counts the bytes K7 reads
    (``observability.kkt_matvec_bytes``), the ideal one the function's
    (:func:`ideal_matvec_bytes`), both against the H100 SXM's HBM rate;
    ``meta`` holds lo, hi, their min times and ``pad_ratio`` (layout bytes
    over ideal bytes). ``hi`` defaults to ≥ 50 ms of matvecs at the ideal
    bound."""
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import KKTLayout

    dev = resolve_device(device)
    inst = generate_mcf_instance(arcs, rho=rho, instance_id=1)
    m, p = inst.num_arcs, inst.num_nodes
    lay = KKTLayout.build(inst.quad_costs, inst.arc_u, inst.arc_v, p, dev)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(m + p).astype(np.float32)
    x = torch.from_numpy(x / np.linalg.norm(x)).to(dev)

    ideal = ideal_matvec_bytes(m, p)
    if hi is None:
        est = ideal / H100_SXM_HBM3_BW
        hi = lo + max(int(0.05 / max(est, 1e-6)), 64)
    if hi <= lo:
        raise ValueError(f"hi ({hi}) must exceed lo ({lo})")
    sample = (_graph_sampler(lay, x) if dev.type == "cuda"
              else _host_sampler(lay, x))
    reps = max(reps, 1)
    t_lo = min(sample(lo) for _ in range(reps))
    t_hi = min(sample(hi) for _ in range(reps))
    per = (t_hi - t_lo) / (hi - lo)
    sol_ideal = SoLReport(nnz=5 * m, bytes_per_matvec=ideal,
                          sol_seconds=ideal / H100_SXM_HBM3_BW,
                          achieved_seconds=per)
    return (per, kkt_spmv_sol(m, p, per), sol_ideal,
            dict(lo=lo, hi=hi, t_lo=t_lo, t_hi=t_hi,
                 pad_ratio=kkt_matvec_bytes(m, p) / ideal))
