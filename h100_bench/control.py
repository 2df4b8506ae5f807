#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from.

For one cell, at its own size: the program's numbers on a dozen or more
seeds (the first call of a run with that seed, compared as a run compares
it: the lower readings) and the control's on three or more (the upper
readings). The control is the plain reference put in the program's place
and computed in TF32, the precision below the configuration's float32
with TF32 off (``references.<name>.Precision.TF32``).

Usage, from the root of a checkout, on a card::

    python3 h100_bench/control.py --workload kkt500k.two_pass \\
        --seeds 1-12 --control-seeds 1-3 [--out chiprun_out/control.json]

Prints one JSON record per solve and, last, each number's largest program
reading and smallest control reading: every number the outputs give,
those a cell's limits leave out among them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

import torch  # noqa: E402

from h100_bench import compare, harness  # noqa: E402


def seed_list(text: str) -> list:
    """``"1-12"`` or ``"3,5,9"`` as a list of seeds."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(spec: dict, workload: str, seeds, control_seeds, device: str,
             bench: Path = harness.BENCH, entry=None, emit=print):
    """``(program, control)``: each a list of per-solve number dicts."""
    _, config, traffic, _ = harness.load_cell(spec, workload, bench)
    dev = torch.device(device)
    entry = entry or harness.module("entries", traffic["entry"], bench)
    inst = harness.instance(config, bench)
    n = inst.num_arcs + inst.num_nodes
    reference = harness.module("references", config["reference"], bench)
    k, f, tol = traffic["k"], traffic["f"], config["breakdown_tol"]

    got = {}
    system = entry.build(inst, traffic, dev)
    for seed in seeds:
        out = entry.solve(system, harness.Rhs(seed, n, dev)(0), traffic)
        got[seed] = compare.host_output(out)
    del system, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    exact = reference.KKTMatrix(inst.quad_costs, inst.arc_u, inst.arc_v,
                                inst.num_nodes, dev)
    low = reference.KKTMatrix(inst.quad_costs, inst.arc_u, inst.arc_v,
                              inst.num_nodes, dev, reference.Precision.TF32)
    program, control = [], []
    for seed in sorted(set(seeds) | set(control_seeds)):
        b = harness.Rhs(seed, n, dev)(0)
        ref = reference.solve(exact, b.double(), k, f, tol)
        if seed in got:
            nums = compare.numbers(got[seed], ref)
            program.append(nums)
            emit(json.dumps({"side": "program", "seed": seed, **nums}))
        if seed in control_seeds:
            c = reference.solve(low, b, k, f, tol)
            ctl = {"x": c.x, "alphas": c.alphas, "betas": c.betas,
                   "steps": c.steps, "b_norm": c.b_norm}
            nums = compare.numbers(ctl, ref)
            control.append(nums)
            emit(json.dumps({"side": "control", "seed": seed, **nums}))
    return program, control


def summary(program, control) -> dict:
    """Each number's largest program reading and smallest control one."""
    names = sorted({name for nums in program + control for name in nums})
    return {name: {"lower": max(p[name] for p in program) if program else None,
                   "upper": min(c[name] for c in control) if control else None}
            for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("control.py measures on a card; torch sees none",
              file=sys.stderr)
        return 2
    program, control = readings(spec, args.workload, seed_list(args.seeds),
                                seed_list(args.control_seeds), "cuda")
    result = {"workload": args.workload, "card": harness.card(
        torch.device("cuda")), "summary": summary(program, control),
        "program": program, "control": control}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({"workload": args.workload, "card": result["card"],
                      "summary": result["summary"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
