"""Driver entry points: the single-device two-pass step and the multi-rank
dry run.

Counterpart of ``__graft_entry__.py``:

* :func:`entry` is its ``entry()``: a two-pass f(A)·b forward step on one
  device (the KKT operator's matvec, K8 on a card) and its arguments;
* :func:`dryrun_multichip` is its ``dryrun_multichip(n)``: the whole
  distributed step over ``n`` ranks, the legs in the same order, on the
  same instance, with the same k, degrees, intervals and thresholds, each
  leg held to a single-device oracle on that instance (the row-sharded and
  arc-sharded solves, the double-float arc-sharded solve, and the sharded
  capability layer). Every failed check raises :class:`DryRunError`.

Where the JAX package passes ``jax.random.key(0)``, the port passes the
seed 0 to both sides (its keys are CPU generators or int seeds). The ranks
are processes: on the card one NCCL rank a card (one rank runs in this
process, on ``make_mesh(1)``), on the CPU gloo ranks started by
``tools/_spawn.py``, the counterpart of the JAX dry run on virtual CPU
devices. Run it as::

    python -m two_pass_lanczos_tpu_torch.entry [--device cpu] [--ranks N]

which prints the two lines of ``__graft_entry__.py``'s ``__main__``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from two_pass_lanczos_tpu_torch.algorithms.block import solve_fAb_block
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import chebyshev_fAb
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.eigen import eigsh
from two_pass_lanczos_tpu_torch.operators import KKTOperator
from two_pass_lanczos_tpu_torch.parallel import (
    DFShardedFusedKKTSolver,
    ShardedFusedKKTSolver,
    ShardedSparseOperator,
    initialize_distributed,
    make_mesh,
)
from two_pass_lanczos_tpu_torch.slq import slq_trace
from two_pass_lanczos_tpu_torch.solvers import solve_fAb
from two_pass_lanczos_tpu_torch.tools._spawn import free_port, spawn_ranks
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

__all__ = ["entry", "dryrun_multichip", "DryRunError", "check_legs",
           "oracle_legs"]

#: seconds the ranks of a dry run may take, start-up included
RANK_TIMEOUT_S = 600
#: the mesh width of the double-float leg, as in ``__graft_entry__.py``
DF_RANKS = 4
#: the relative tolerance of every leg against its oracle
REL = 1e-3


class DryRunError(AssertionError):
    """A leg of the dry run broke its contract or left its oracle."""


def _tiny_kkt(m=256, p=32, dtype=np.float32, seed=0):
    """A tiny synthetic KKT problem with O(1)-scaled costs."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(dtype)
    b = rng.standard_normal(m + p).astype(dtype)
    return d, u, v, p, b


def entry(device=DEFAULT_DEVICE):
    """``(forward, args)``: the two-pass f(A)·b forward step on one device
    and its arguments, tensors on ``device``. ``forward(d, arc_u, arc_v,
    b)`` builds the KKT operator (K8 on a card) and returns
    ``solve_fAb(op, b, k=16, f="inv", method="two_pass")``: 2k − 1 = 31
    matvecs."""
    dev = resolve_device(device)
    d, u, v, p, b = _tiny_kkt()

    def forward(d, arc_u, arc_v, b):
        op = KKTOperator(d, arc_u, arc_v, p, device=b.device)
        return solve_fAb(op, b, k=16, f="inv", method="two_pass")

    args = tuple(torch.from_numpy(a).to(dev) for a in (d, u, v, b))
    return forward, args


def _square(t):
    return t * t


def _b_block(n: int) -> np.ndarray:
    """The block leg's (n, 2) f32 right-hand sides."""
    return np.random.default_rng(1).standard_normal((n, 2)).astype(
        np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def oracle_legs(device) -> dict:
    """The single-device oracle of every capability leg, on the dry run's
    instance: the KKT operator (K8 on a card) under the host solvers."""
    dev = resolve_device(device)
    d, u, v, p, b = _tiny_kkt()
    m = d.shape[0]
    op = KKTOperator(d, u, v, p, device=dev)
    bt = torch.from_numpy(b).to(dev)
    return {
        "chebyshev": _np(chebyshev_fAb(op, bt, "exp", degree=6,
                                       interval=(-4.0, 4.0))),
        "slq": float(slq_trace(op, _square, k=3, num_probes=2,
                               key=0).estimate),
        "eigsh": np.asarray(eigsh(op, nev=2, which="LA", ncv=6, tol=1e-2,
                                  maxiter=3, key=0).eigenvalues),
        "block": _np(solve_fAb_block(
            op, torch.from_numpy(_b_block(m + p)).to(dev), 3, _square)),
        "fused_chebyshev": _np(chebyshev_fAb(op, bt, "exp", degree=5,
                                             interval=(-4.0, 4.0))),
    }


def run_legs(mesh, mesh_df) -> dict:
    """Every leg of the distributed step on this rank, in
    ``__graft_entry__.py``'s order: the row-sharded two-pass and one-pass
    solves (k = 8), the arc-sharded fused solve (K7 on a card), the
    double-float arc-sharded solve (K12) on ``mesh_df`` (None on the ranks
    outside it), then the row-sharded Chebyshev, SLQ, eigsh and block
    solves and the fused SLQ and Chebyshev."""
    d, u, v, p, b = _tiny_kkt()
    m = d.shape[0]
    # the 5m f32 KKT triplets, assembled as __graft_entry__.py does
    sop = ShardedSparseOperator.from_kkt_arrays(
        KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p, num_arcs=m),
        mesh, dtype=np.float32)
    x, dec = sop.solve_fAb(b, k=8, f="inv", method="two_pass")
    x1, _ = sop.solve_fAb(b, k=8, f="inv", method="one_pass")
    got = {"row": (x, dec.steps()), "row_one_pass": x1}
    sf = ShardedFusedKKTSolver(d, u, v, p, mesh)
    xf, decf = sf.solve(b, k=8, f="inv", method="two_pass")
    got["fused"] = (xf, decf.steps())
    got["df"] = None
    if mesh_df is not None:
        sdf = DFShardedFusedKKTSolver(d.astype(np.float64), u, v, p, mesh_df)
        xdf, (_, _, steps_df) = sdf.solve(b.astype(np.float64), k=3, f="inv")
        got["df"] = (xdf, int(steps_df))
    got["chebyshev"] = sop.chebyshev_fAb(b, "exp", degree=6,
                                         interval=(-4.0, 4.0))
    got["slq"] = float(sop.slq_trace(_square, k=3, num_probes=2,
                                     key=0).estimate)
    res = sop.eigsh(nev=2, which="LA", ncv=6, tol=1e-2, maxiter=3, key=0)
    got["eigsh"] = (np.asarray(res.eigenvalues), res.eigenvectors)
    got["block"] = sop.solve_fAb_block(_b_block(m + p), k=3, f=_square)
    got["fused_slq"] = float(sf.slq_trace(_square, k=3, num_probes=2,
                                          key=0).estimate)
    got["fused_chebyshev"] = sf.chebyshev_fAb(b, "exp", degree=5,
                                              interval=(-4.0, 4.0))
    return got


def _require(cond, what: str) -> None:
    if not cond:
        raise DryRunError(what)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def check_legs(got: dict, oracle: dict) -> None:
    """The checks of ``__graft_entry__.py``'s ``dryrun_multichip``, in its
    order, on one rank's legs (:func:`run_legs`) and the oracle
    (:func:`oracle_legs`); raises :class:`DryRunError` at the first leg
    that fails."""
    d, _, _, p, _ = _tiny_kkt()
    n = d.shape[0] + p
    x, steps = got["row"]
    _require(x.shape == (n,), f"row-sharded x has shape {x.shape}, not "
                              f"({n},)")
    _require(np.all(np.isfinite(x)),
             "distributed solve produced non-finite values")
    _require(steps == 8, f"row-sharded solve took {steps} steps, not 8")
    _require(np.all(np.isfinite(got["row_one_pass"])),
             "row-sharded one-pass solve produced non-finite values")
    xf, steps_f = got["fused"]
    _require(np.all(np.isfinite(xf)), "fused sharded solve produced "
                                      "non-finite values")
    _require(steps_f == 8, f"fused sharded solve took {steps_f} steps, "
                           "not 8")
    rel = _rel(xf, x)
    _require(rel < REL, f"fused vs generic sharded solve diverged: {rel}")
    if got["df"] is not None:
        xdf, steps_df = got["df"]
        _require(steps_df == 3, f"df sharded solve took {steps_df} steps, "
                                "not 3")
        _require(np.all(np.isfinite(xdf)),
                 "df sharded solve produced non-finite values")
    rel = _rel(got["chebyshev"], oracle["chebyshev"])
    _require(rel < REL, f"sharded chebyshev vs host oracle: rel {rel}")
    est, est_h = got["slq"], oracle["slq"]
    _require(abs(est - est_h) <= REL * abs(est_h),
             f"sharded slq vs host oracle: {est} vs {est_h}")
    values, vectors = got["eigsh"]
    rel = _rel(values, oracle["eigsh"])
    _require(rel < REL, f"sharded eigsh vs host oracle: rel {rel}")
    _require(np.all(np.isfinite(vectors)),
             "sharded eigsh produced non-finite eigenvectors")
    rel = _rel(got["block"], oracle["block"])
    _require(rel < REL, f"sharded block vs host oracle: rel {rel}")
    est_f = got["fused_slq"]
    _require(abs(est_f - est_h) <= REL * abs(est_h),
             f"fused sharded slq vs host oracle: {est_f} vs {est_h}")
    rel = _rel(got["fused_chebyshev"], oracle["fused_chebyshev"])
    _require(rel < REL, f"fused sharded chebyshev vs host oracle: rel {rel}")


def _dryrun_rank(mesh) -> None:
    """One rank's dry run on ``mesh``: the legs, the oracle on this rank's
    device, and the checks."""
    mesh_df = make_mesh(min(mesh.size, DF_RANKS), device=mesh.device)
    check_legs(run_legs(mesh, mesh_df), oracle_legs(mesh.device))


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """Run the whole distributed two-pass step over ``n_devices`` ranks,
    once, every leg checked against its single-device oracle; raises
    :class:`DryRunError` if a leg fails.

    On the card (``device="cuda"``, the default) each rank drives its own
    card over NCCL, and fewer cards than ranks raise ``RuntimeError``; one
    rank runs in this process on ``make_mesh(1)`` (the default process
    group, if one is up, or a one-rank group formed and taken down here).
    With ``device="cpu"`` the ranks are gloo processes."""
    dev = resolve_device(device)
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"need {n} cuda devices, have {have}")
        if n == 1:
            formed = not dist.is_initialized()
            try:
                _dryrun_rank(make_mesh(1, device=dev))
            finally:
                if formed and dist.is_initialized():
                    dist.destroy_process_group()
            return
    init = f"tcp://localhost:{free_port()}"
    results = spawn_ranks(
        "two_pass_lanczos_tpu_torch.entry", n,
        lambda r: ["--device", dev.type, "--rank", r, "--world", n,
                   "--init-method", init], RANK_TIMEOUT_S)
    failed = [r for r, res in enumerate(results) if res.returncode != 0]
    if failed:
        raise DryRunError(
            f"dry run rank(s) {failed} of {n} failed:\n" + "\n".join(
                results[r].stderr[-3000:] for r in failed))


def _main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m two_pass_lanczos_tpu_torch.entry",
        description="The single-device two-pass step, then the dry run of "
                    "the distributed step over N ranks.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: every card, at "
                         "most 8; 8 on the CPU)")
    ap.add_argument("--rank", type=int, default=None,
                    help="run one rank of a dry run (with --world and "
                         "--init-method), as dryrun_multichip starts them")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        initialize_distributed(args.init_method, args.world, args.rank,
                               device=args.device)
        try:
            _dryrun_rank(make_mesh(args.world, device=args.device))
        finally:
            dist.destroy_process_group()
        return 0
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry() ok:", tuple(out.shape), str(out.dtype).split(".")[-1])
    n = args.ranks
    if n is None:
        n = min(torch.cuda.device_count(), 8) if args.device == "cuda" else 8
    dryrun_multichip(n, device=args.device)
    print(f"dryrun_multichip({n}) ok")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
