"""A copy of the benchmark's tree with small cells, for the CPU tests.

``tiny_tree(path)`` copies ``h100_bench/`` under ``path`` and adds, as a
later change would, a configuration of 3,000 arcs (``mcf3k_rho3``), one
traffic mix per real one at k = 20 and a cell ``tiny.<mix>`` for each,
with limits of its own. At this size and k the float32 program's x lies
within 2e-5 of float64's and the TF32 control's 1.5e-2 or more away (seeds
1-3), so ``x_gap`` is held to 1e-3 here; ``bnorm_gap`` reads up to 3.8e-8
against the control's 5.4e-7 or more (seeds 1-12 and 1-3), ``ritz_gap``
6.3e-8 against 1.8e-4. It also adds the test-only entry
``tiny_sharded`` (``sharded_entry.py``: ``ShardedFusedKKTSolver`` over
gloo) and two cells of it on 2 and 4 ranks, ``tiny.sharded2`` and
``tiny.sharded4``, held to the fused limits. It writes the spec (the real
``BENCHMARK.json`` with each new cell in the lists of the metrics its
real cell has) beside the copy, so that the copy's ``run.py`` runs it, and
returns the spec and the copy's path. No file of the real tree is edited.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from h100_bench import harness

K = 20
FUSED = {"steps_gap": 0, "bnorm_gap": 2e-7, "ab_gap": 3e-5,
         "ritz_gap": 3e-6, "x_gap": 1e-3}
LIMITS = {"two_pass": FUSED, "one_pass": FUSED, "sparse": {"x_gap": 1e-3}}
REAL_CELL = {"two_pass": "kkt500k.two_pass", "one_pass": "kkt500k.one_pass",
             "sparse": "kkt500k.sparse"}
#: the multi-rank cells: name -> ranks
SHARDED = {"tiny.sharded2": 2, "tiny.sharded4": 4}


def tiny_tree(path: Path):
    bench = Path(path) / "h100_bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.load_json(bench / "configs" / "mcf500k_rho3.json")
    cfg.update(name="mcf3k_rho3", num_nodes=None, n=None)
    cfg["instance"]["arcs"] = 3000
    (bench / "configs" / "mcf3k_rho3.json").write_text(json.dumps(cfg))
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for mix, real in REAL_CELL.items():
        traffic = harness.load_json(bench / "traffic" / f"{mix}.json")
        traffic.update(k=K, trace_after_solves=1, trace_solves=2)
        (bench / "traffic" / f"tiny_{mix}.json").write_text(
            json.dumps(traffic))
        (bench / "limits" / f"tiny.{mix}.json").write_text(
            json.dumps(LIMITS[mix]))
        spec["workloads"].append({"name": f"tiny.{mix}",
                                  "config": "mcf3k_rho3",
                                  "traffic": f"tiny_{mix}", "chips": 1,
                                  "why": "a small cell for the CPU tests"})
        for metric in spec["per_layer"] + spec["end_to_end"]:
            if real in metric.get("workloads", ()):
                metric["workloads"].append(f"tiny.{mix}")
    shutil.copy(Path(__file__).with_name("sharded_entry.py"),
                bench / "entries" / "tiny_sharded.py")
    traffic = harness.load_json(bench / "traffic" / "tiny_two_pass.json")
    traffic["entry"] = "tiny_sharded"
    (bench / "traffic" / "tiny_sharded.json").write_text(json.dumps(traffic))
    for cell, world in SHARDED.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(FUSED))
        spec["workloads"].append({"name": cell, "config": "mcf3k_rho3",
                                  "traffic": "tiny_sharded", "chips": world,
                                  "why": "a multi-rank cell for the tests"})
        for metric in spec["per_layer"] + spec["end_to_end"]:
            if REAL_CELL["two_pass"] in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (Path(path) / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, bench
