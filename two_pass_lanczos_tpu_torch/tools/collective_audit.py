"""Record the multi-rank evidence table of the distributed designs.

Counterpart of ``scripts/collective_audit.py``. It runs gloo ranks on the
CPU, as the JAX script runs a virtual CPU mesh, and prints four JSON lines:

1. the collectives of one k-step two-pass solve of both distributed
   designs at the largest D of ``--ranks``, from
   ``utils.collectives.record_collectives()`` (the port writes no compiled
   program to read): each kind, dtype and shape with its count and bytes,
   the bytes a step moves (the row partition's O(n) vector gather against
   the arc-sharded solver's O(p) node gather), and the first events of
   each solve in order;
2. the same for the double-float arc-sharded solver (at most 20,000 arcs):
   all-gathers only, folded in rank order, never an all-reduce;
3. the snake partition's nnz per rank and its max/mean;
4. the row-partitioned f64 two-pass solve's wall time at each D of
   ``--ranks``: CPU gloo times, correctness-grade only.

Usage::

    python -m two_pass_lanczos_tpu_torch.tools.collective_audit --arcs 500000
"""

from __future__ import annotations

import argparse
import json
import sys
import time

MODULE = "two_pass_lanczos_tpu_torch.tools.collective_audit"
#: arcs of the df solver's audit instance at most (its eager recurrence
#: takes ~1,000 launches a step)
DF_ARCS = 20_000
EVENTS_HEAD = 12


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arcs", type=int, default=500_000)
    ap.add_argument("--k", type=int, default=30)
    ap.add_argument("--rho", type=int, default=3)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4],
                    help="the D of the timed solves; the largest is audited")
    ap.add_argument("--timeout", type=int, default=900)
    # one rank's part (the orchestrator passes them)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--audit", action="store_true")
    return ap


def _ops(log) -> list:
    return [{"kind": o.kind, "dtype": o.dtype, "shape": list(o.shape),
             "count": o.count, "bytes_out": o.bytes_out} for o in log.ops()]


def rank_main(args) -> int:
    import numpy as np
    import torch.distributed as dist

    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )
    from two_pass_lanczos_tpu_torch.parallel import (
        DFShardedFusedKKTSolver,
        ShardedFusedKKTSolver,
        ShardedSparseOperator,
        initialize_distributed,
        make_mesh,
    )
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        record_collectives,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    initialize_distributed(args.init_method, args.world, args.rank,
                           device="cpu")
    mesh = make_mesh(device="cpu")
    inst = generate_mcf_instance(args.arcs, rho=args.rho, instance_id=1)
    m, p = inst.num_arcs, inst.num_nodes
    arrays = KKTArrays(inst.quad_costs, inst.arc_u, inst.arc_v, p, m)
    b = np.random.default_rng(0).standard_normal(m + p)
    op = ShardedSparseOperator.from_kkt_arrays(arrays, mesh,
                                               dtype=np.float64)
    out = {"ranks": mesh.size}
    if args.audit:
        with record_collectives() as glog:
            op.solve_fAb(b, k=args.k, f="inv", method="two_pass")
        sf = ShardedFusedKKTSolver(inst.quad_costs.astype(np.float32),
                                   inst.arc_u, inst.arc_v, p, mesh)
        with record_collectives() as flog:
            sf.solve(b.astype(np.float32), k=args.k, f="inv")
        inst_df = generate_mcf_instance(min(args.arcs, DF_ARCS),
                                        rho=args.rho, instance_id=1)
        sdf = DFShardedFusedKKTSolver(inst_df.quad_costs, inst_df.arc_u,
                                      inst_df.arc_v, inst_df.num_nodes, mesh)
        with record_collectives() as dlog:
            sdf.solve(np.random.default_rng(0).standard_normal(sdf.n),
                      k=args.k, f="inv")
        out.update(
            generic=_ops(glog), fused=_ops(flog), df=_ops(dlog),
            generic_events=glog.events[:EVENTS_HEAD],
            fused_events=flog.events[:EVENTS_HEAD],
            df_arcs=inst_df.num_arcs, width=max(sf.shard_sizes),
            rows_per=op.part.rows_per,
            nnz_per_device=[int(x) for x in op.nnz_per_device])
    op.solve_fAb(b, k=args.k, f="inv", method="two_pass")  # warm
    t0 = time.perf_counter()
    op.solve_fAb(b, k=args.k, f="inv", method="two_pass")
    out["solve_s"] = time.perf_counter() - t0
    if mesh.rank == 0:
        print("AUDIT " + json.dumps(out), flush=True)
    dist.barrier(group=mesh.group)
    dist.destroy_process_group()
    return 0


def _per_call(ops, kind, shape) -> int:
    """Bytes of one call of the collective of ``kind`` and ``shape``."""
    return next(o["bytes_out"] // o["count"] for o in ops
                if o["kind"] == kind and o["shape"] == list(shape))


def orchestrate(args) -> int:
    from two_pass_lanczos_tpu_torch.models.generator import nodes_for
    from two_pass_lanczos_tpu_torch.tools._spawn import free_port, spawn_ranks

    audit_d = max(args.ranks)
    got = {}
    for d in sorted(set(args.ranks)):
        init = f"tcp://localhost:{free_port()}"
        ranks = spawn_ranks(MODULE, d, lambda r: [
            "--rank", r, "--world", d, "--init-method", init,
            "--arcs", args.arcs, "--k", args.k, "--rho", args.rho,
            *(["--audit"] if d == audit_d else [])], args.timeout)
        if any(r.returncode != 0 for r in ranks):
            sys.stderr.write("rank failure at D=%d:\n%s\n" % (
                d, "\n".join(r.stderr for r in ranks)[-3000:]))
            return 1
        lines = [ln for ln in ranks[0].stdout.splitlines()
                 if ln.startswith("AUDIT ")]
        if not lines:
            sys.stderr.write(f"rank 0 at D={d} printed no result\n")
            return 1
        got[d] = json.loads(lines[0].split(" ", 1)[1])

    a = got[audit_d]
    p = nodes_for(args.arcs, args.rho)
    # a step: the row partition gathers the padded Krylov vector, the
    # arc-sharded solver the (D, p) node partials
    gather = _per_call(a["generic"], "all-gather-start",
                       (audit_d, a["rows_per"]))
    node = _per_call(a["fused"], "all-gather", (audit_d, p))
    print(json.dumps({
        "instance": {"arcs": args.arcs, "nodes": p, "n": args.arcs + p},
        "ranks": audit_d, "k": args.k,
        "generic_collectives": a["generic"],
        "fused_collectives": a["fused"],
        "rows_per": a["rows_per"], "fused_width": a["width"],
        "per_step_measured": {"generic_all_gather_bytes": gather,
                              "fused_node_gather_bytes": node,
                              "ratio": gather / node},
        "generic_events_head": a["generic_events"],
        "fused_events_head": a["fused_events"],
    }))
    print(json.dumps({
        "df_sharded": a["df"], "df_arcs": a["df_arcs"],
        "df_invariant": "all-gather only (df partials folded locally in "
                        "rank order); an all-reduce here would re-round "
                        "df to f32",
        "df_all_reduce_count": sum(o["count"] for o in a["df"]
                                   if o["kind"] == "all-reduce"),
    }))
    per = a["nnz_per_device"]
    print(json.dumps({"nnz_per_device": per,
                      "imbalance_max_over_mean": max(per) * len(per)
                      / sum(per)}))
    print(json.dumps({
        "gloo_solve_s": {str(d): got[d]["solve_s"] for d in sorted(got)},
        "note": "CPU wall times of gloo ranks on one host: "
                "correctness-grade only; the byte table above is the "
                "traffic per step"}))
    return 0


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import setup_logging

    args = build_parser().parse_args(argv)
    setup_logging()
    if args.rank is not None:
        return rank_main(args)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
