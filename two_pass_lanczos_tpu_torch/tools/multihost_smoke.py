"""Multi-process smoke: the arc-sharded fused solver over N processes.

Counterpart of ``scripts/multihost_smoke.py``, with its flags. Each of N
processes (one per rank; gloo on the CPU, NCCL with one card a rank) joins
the process group through ``parallel.mesh.initialize_distributed``, builds
the same seeded instance (m = 4000, p = 300), solves it with
``ShardedFusedKKTSolver(...).solve(b, k=12, f="inv", raw=True)`` and runs
``slq_trace`` on it; every rank checks the replicated scalars (12 steps,
finite x and SLQ estimate), and ‖b‖ against the single-process oracle the
launcher passes in (``--expect-bnorm``, rel 1e-5). Rank 0 prints
``MULTIHOST_OK bnorm=... steps=... xn_norm=... slq=...``.

Usage, one process per rank (what ``tests/test_torch_tools.py`` runs)::

    python -m two_pass_lanczos_tpu_torch.tools.multihost_smoke \
        --num-processes 2 --process-id $I --coordinator localhost:12345 \
        --expect-bnorm <oracle> --torch-device cpu
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="devices a process drives: one under "
                         "torch.distributed")
    ap.add_argument("--expect-bnorm", type=float, default=None)
    add_torch_device(ap)
    return ap


def instance():
    """The smoke's seeded instance ``(d, u, v, p, b)``; the launcher's
    oracle ‖b‖ is that of this b."""
    import numpy as np

    rng = np.random.default_rng(11)
    m, p = 4000, 300
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    b = rng.standard_normal(m + p).astype(np.float32)
    return d, u, v, p, b


def main(argv=None) -> int:
    import numpy as np
    import torch.distributed as dist

    from two_pass_lanczos_tpu_torch.devices import resolve_device
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log_device,
        setup_logging,
    )
    from two_pass_lanczos_tpu_torch.parallel import (
        ShardedFusedKKTSolver,
        initialize_distributed,
        make_mesh,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    if args.devices_per_process != 1:
        raise SystemExit("--devices-per-process: a torch.distributed "
                         "process drives one device")
    device = resolve_device(args.torch_device)
    log_device(device)
    initialize_distributed(f"tcp://{args.coordinator}", args.num_processes,
                           args.process_id, device=device)
    mesh = make_mesh(device=device)
    if mesh.size != args.num_processes:
        raise RuntimeError(f"mesh of {mesh.size} ranks, expected "
                           f"{args.num_processes}")

    d, u, v, p, b = instance()
    solver = ShardedFusedKKTSolver(d, u, v, p, mesh)
    (xa, xn), dec = solver.solve(b, k=12, f="inv", raw=True)
    # the decomposition and the node block are replicated on every rank
    b_norm = float(dec.b_norm)
    steps = dec.steps()
    xn_np = xn.cpu().numpy()
    if steps != 12 or not np.all(np.isfinite(xn_np)):
        raise RuntimeError(f"steps {steps}, finite x_n "
                           f"{bool(np.all(np.isfinite(xn_np)))}")
    if args.expect_bnorm is not None:
        rel = abs(b_norm - args.expect_bnorm) / args.expect_bnorm
        if not rel < 1e-5:
            raise RuntimeError(f"|b| {b_norm!r} against the oracle's "
                               f"{args.expect_bnorm!r} (rel {rel:.2e})")
    # the capability layer across processes: tr A² by SLQ, replicated
    slq_est = float(solver.slq_trace(lambda t: t * t, k=4, num_probes=2,
                                     key=0).estimate)
    if not np.isfinite(slq_est):
        raise RuntimeError(f"slq_trace estimate {slq_est}")

    if mesh.rank == 0:
        print(f"MULTIHOST_OK bnorm={b_norm!r} steps={steps} "
              f"xn_norm={float(np.linalg.norm(xn_np))!r} slq={slq_est!r}",
              flush=True)
    dist.barrier(group=mesh.group)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
