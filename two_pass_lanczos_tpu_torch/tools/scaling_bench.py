"""Multi-process scaling benchmark: per-step time and nnz/s of the
distributed designs over N ``torch.distributed`` processes.

Counterpart of ``scripts/scaling_bench.py``, with its flags and record
schema:

* launched WITHOUT ``--process-id`` it is the orchestrator: for each N of
  ``--processes`` it starts N workers of itself, reads rank 0's
  ``SCALING_RESULT`` line, and prints one JSON record per (design, N);
* launched WITH ``--process-id`` it is one rank: it joins the process group
  through ``parallel.mesh.initialize_distributed`` (gloo on the CPU, NCCL
  on cards, one card a rank), builds the instance, and times the solves.

Designs: ``fused`` (``ShardedFusedKKTSolver``: per step the O(p) node
partials, on K7), ``generic`` (``ShardedSparseOperator``, the row
partition: per step the O(n) Krylov vector) and ``df``
(``DFShardedFusedKKTSolver`` on K12).

``meaningful`` is true only when every rank drove a card of its own and
N ≥ 2: gloo ranks on the CPU and one-card runs are correctness-grade and
print false. NCCL refuses two ranks on one card, so N ranks on cards need
N cards.

Usage::

    python -m two_pass_lanczos_tpu_torch.tools.scaling_bench \
        --processes 1 2 --arcs 100000 --k 50 --torch-device cpu

Record (one line per (design, N))::

    {"metric": "scaling_<design>_nproc<N>", "seconds_per_step": float,
     "nnz_per_s": float, "efficiency_vs_1proc": float|null,
     "arcs": int, "k": int, "ndev": int, "meaningful": bool,
     "device": str, "card": str}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

MODULE = "two_pass_lanczos_tpu_torch.tools.scaling_bench"
DESIGNS = ("fused", "generic", "df")


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--processes", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the rendezvous (a worker's; the "
                         "orchestrator passes localhost:<--port>)")
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="devices a process drives: one card (or the CPU) "
                         "under torch.distributed")
    ap.add_argument("--backend", choices=["cpu", "tpu"], default=None,
                    help="the JAX script's platform: 'cpu' is the CPU, "
                         "'tpu' the accelerator (here the card); unset, "
                         "--torch-device decides")
    ap.add_argument("--arcs", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--designs", nargs="+", default=["fused", "generic"],
                    choices=list(DESIGNS))
    ap.add_argument("--output", default=None,
                    help="also write the orchestrator's JSON records here")
    ap.add_argument("--port", type=int, default=0,
                    help="rendezvous port (0: a free one)")
    ap.add_argument("--timeout", type=int, default=900)
    add_torch_device(ap)
    return ap


def _device_name(args) -> str:
    if args.backend is not None:
        return "cpu" if args.backend == "cpu" else "cuda"
    return args.torch_device


def worker(args) -> int:
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from two_pass_lanczos_tpu_torch.devices import resolve_device
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
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays
    from two_pass_lanczos_tpu_torch.utils.perf import (
        card_description,
        synchronize,
    )

    device = resolve_device(_device_name(args))
    initialize_distributed(f"tcp://{args.coordinator}", args.num_processes,
                           args.process_id, device=device)
    mesh = make_mesh(device=device)
    # which card each rank drives: distinct (host, card) pairs on every
    # rank make a run meaningful
    where = (socket.gethostname(),
             mesh.device.index if mesh.device.type == "cuda" else -1)
    everywhere = [None] * mesh.size
    dist.all_gather_object(everywhere, where, group=mesh.group)
    own_cards = (mesh.device.type == "cuda"
                 and len(set(everywhere)) == mesh.size)

    inst = generate_mcf_instance(args.arcs, rho=3, instance_id=1)
    m, p = inst.num_arcs, inst.num_nodes
    b = np.random.default_rng(0).standard_normal(m + p).astype(np.float32)
    nnz = 5 * m
    out = {}

    def timed(run):
        synchronize(run())  # warm
        t0 = time.perf_counter()
        reps = max(args.reps, 1)
        for _ in range(reps):
            synchronize(run())
        return (time.perf_counter() - t0) / reps

    def record(name, t):
        out[name] = dict(seconds_per_step=t / (2 * args.k),
                         nnz_per_s=nnz * 2 * args.k / t)

    if "fused" in args.designs:  # arc-sharded: (D, p) node gathers a step
        sf = ShardedFusedKKTSolver(inst.quad_costs.astype(np.float32),
                                   inst.arc_u, inst.arc_v, p, mesh)
        bt = torch.from_numpy(b)
        record("fused", timed(
            lambda: sf.solve(bt, k=args.k, f="inv", raw=True)[0]))
        sf.release_graphs()
    if "generic" in args.designs:  # row partition: the O(n) vector a step
        op = ShardedSparseOperator.from_kkt_arrays(
            KKTArrays(inst.quad_costs, inst.arc_u, inst.arc_v, p, m), mesh,
            dtype=np.float32)
        record("generic", timed(lambda: op.solve_fAb(
            b, k=args.k, f="inv", method="two_pass", raw=True)[0]))
    if "df" in args.designs:  # double-float arc-sharded, on K12
        sdf = DFShardedFusedKKTSolver(inst.quad_costs, inst.arc_u,
                                      inst.arc_v, p, mesh)
        b64 = b.astype(np.float64)
        record("df", timed(
            lambda: sdf.solve(b64, k=args.k, f="inv", raw=True)[0]))

    if mesh.rank == 0:
        print("SCALING_RESULT " + json.dumps(dict(
            ndev=mesh.size, nproc=args.num_processes,
            device=mesh.device.type, card=card_description(mesh.device),
            own_cards=own_cards, **out)), flush=True)
    dist.barrier(group=mesh.group)
    dist.destroy_process_group()
    return 0


def orchestrate(args) -> int:
    from two_pass_lanczos_tpu_torch.devices import resolve_device
    from two_pass_lanczos_tpu_torch.experiments.common import log_device
    from two_pass_lanczos_tpu_torch.tools._spawn import free_port, spawn_ranks

    log_device(resolve_device(_device_name(args)))
    results = {}
    for nproc in args.processes:
        port = args.port or free_port()
        ranks = spawn_ranks(MODULE, nproc, lambda r: [
            "--process-id", r, "--num-processes", nproc,
            "--coordinator", f"localhost:{port}",
            "--arcs", args.arcs, "--k", args.k, "--reps", args.reps,
            "--designs", *args.designs,
            "--torch-device", _device_name(args)], args.timeout)
        if any(r.returncode != 0 for r in ranks):
            sys.stderr.write("worker failure at N=%d:\n%s\n" % (
                nproc, "\n".join(r.stderr for r in ranks)[-3000:]))
            return 1
        for line in ranks[0].stdout.splitlines():
            if line.startswith("SCALING_RESULT "):
                results[nproc] = json.loads(line.split(" ", 1)[1])
        if nproc not in results:
            sys.stderr.write(f"rank 0 at N={nproc} printed no result\n")
            return 1
    first = min(results)
    base = results[first]
    records = []
    for nproc in sorted(results):
        r = results[nproc]
        for design in args.designs:
            d = r[design]
            eff = d["nnz_per_s"] / (base[design]["nnz_per_s"] * nproc
                                    / first)
            records.append({
                "metric": f"scaling_{design}_nproc{nproc}",
                "seconds_per_step": d["seconds_per_step"],
                "nnz_per_s": d["nnz_per_s"],
                "efficiency_vs_1proc": eff,
                "arcs": args.arcs, "k": args.k, "ndev": r["ndev"],
                "meaningful": bool(r["own_cards"] and r["ndev"] >= 2),
                "device": r["device"], "card": r["card"],
            })
    for rec in records:
        print(json.dumps(rec))
    if not any(rec["meaningful"] for rec in records):
        note = {"note": "correctness-grade only: gloo ranks on the CPU or "
                        "one card; the efficiency measurement needs one "
                        "card per rank and N >= 2"}
        print(json.dumps(note))
        records.append(note)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({
                "command": " ".join(sys.argv),
                "host": {"physical_cores": os.cpu_count(),
                         "device": _device_name(args),
                         "devices_per_process": args.devices_per_process},
                "records": records,
            }, f, indent=1)
            f.write("\n")
    return 0


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import setup_logging

    args = build_parser().parse_args(argv)
    setup_logging()
    if args.devices_per_process != 1:
        raise SystemExit("--devices-per-process: a torch.distributed "
                         "process drives one device")
    if args.process_id is not None:
        if args.coordinator is None:
            raise SystemExit("a worker needs --coordinator host:port")
        return worker(args)
    return orchestrate(args)


if __name__ == "__main__":
    sys.exit(main())
