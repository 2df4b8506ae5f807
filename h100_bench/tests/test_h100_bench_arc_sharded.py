"""The cell ``kkt5m.arc_sharded.4chip``: its six per-layer readers on a
known stretch, and its entry (``entries/arc_sharded.py``) run through
``run.py`` as a 4-rank cell over gloo on the CPU, at 3,000 arcs."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

from h100_bench import counts, harness, trace
from h100_bench.tests.tiny import FUSED, K, tiny_tree

CELL = "kkt5m.arc_sharded.4chip"
TINY = "tiny.arc_sharded4"
READERS = ("shard_matvec_ms", "shard_matvec_roofline", "fold_ms",
           "folds_per_solve", "launches_per_solve.arc_sharded",
           "device_idle_pct.arc_sharded")
K7 = "void tpl::(anonymous namespace)::kkt_shard_matvec_kernel<false>(float)"
NCCL = "ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long)"


def _raw():
    """Two solves, each one graph launch of two K7 products, two NCCL
    gathers and an elementwise kernel, then a copy launched on its own;
    a draw between them in no solve."""
    host, dev = [], []
    for i, t0 in enumerate((0.0, 100.0)):
        host += [("bench.solve", t0, t0 + 80.0, 10 * i + 1, 0),
                 ("cudaGraphLaunch", t0 + 1.0, t0 + 2.0, 100 + i, 0),
                 ("cudaMemcpyAsync", t0 + 60.0, t0 + 61.0, 200 + i, 0)]
        dev += [(K7, t0 + 2.0, t0 + 12.0, 100 + i, 0),
                (NCCL, t0 + 12.0, t0 + 17.0, 100 + i, 0),
                ("elementwise_kernel", t0 + 17.0, t0 + 18.0, 100 + i, 0),
                (K7, t0 + 20.0, t0 + 30.0, 100 + i, 0),
                (NCCL, t0 + 30.0, t0 + 33.0, 100 + i, 0),
                ("Memcpy DtoD", t0 + 61.0, t0 + 63.0, 200 + i, 0)]
    host.append(("bench.draw", 85.0, 95.0, 99, 0))
    dev.append(("randn", 86.0, 87.0, 99, 0))
    return dev, host


def _ctx(stretch, peak, counters, world=4, m=4000, p=30):
    return types.SimpleNamespace(
        stretch=stretch, solves=stretch.solves, counters=counters,
        peak=peak, world=world, m=m, p=p, n=m + p, steps=[], call_ms=[],
        traffic={"method": "two_pass"})


def _read(name, ctx):
    return harness.module("metrics", name).read(ctx)


def test_the_six_readers_on_a_known_stretch():
    st = trace.reduce_events(*_raw())
    assert [len(s) for s in st.solves] == [6, 6]
    peak = {"f32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    ctx = _ctx(st, peak, {"collectives": 2 * (4 * K + 1)})
    assert _read("shard_matvec_ms", ctx) == pytest.approx(20e-3)
    assert _read("fold_ms", ctx) == pytest.approx(8e-3)
    assert _read("folds_per_solve", ctx) == 4 * K + 1
    assert _read("launches_per_solve.arc_sharded", ctx) == 6
    # busy 10 + 5 + 1 + 10 + 3 + 2 = 31 of each solve's 80 µs
    assert _read("device_idle_pct.arc_sharded", ctx) == pytest.approx(
        100 * (1 - 31 / 80))
    # rank 0's shard: ⌈4000 / 4⌉ arcs over all 30 nodes, 4 products
    least = 4 * counts.least_seconds(*counts.kkt_matvec(1000, 30), peak)
    assert _read("shard_matvec_roofline", ctx) == pytest.approx(
        100 * least / 40e-6)
    uneven = _ctx(st, peak, {}, world=3, m=4001)
    least = 4 * counts.least_seconds(*counts.kkt_matvec(1334, 30), peak)
    assert _read("shard_matvec_roofline", uneven) == pytest.approx(
        100 * least / 40e-6)


def test_the_readers_find_nothing_where_the_cell_has_nothing():
    """On a trace with no K7, NCCL or solve, and no counter, each reader
    returns None and does not raise."""
    empty = trace.reduce_events([], [])
    ctx = _ctx(empty, None, {})
    for name in READERS:
        assert _read(name, ctx) is None, name
    one = trace.reduce_events(*_raw())
    assert _read("shard_matvec_roofline", _ctx(one, None, {})) is None
    assert _read("folds_per_solve", _ctx(one, None, {"other": 3})) is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tiny tree with a 4-rank cell of the arc-sharded entry."""
    path = tmp_path_factory.mktemp("bench")
    spec, bench = tiny_tree(path)
    traffic = harness.load_json(bench / "traffic" / "arc_sharded.json")
    traffic.update(k=K, trace_after_solves=1, trace_solves=2)
    (bench / "traffic" / "tiny_arc_sharded.json").write_text(
        json.dumps(traffic))
    (bench / "limits" / f"{TINY}.json").write_text(json.dumps(FUSED))
    spec["workloads"].append({"name": TINY, "config": "mcf3k_rho3",
                              "traffic": "tiny_arc_sharded", "chips": 4,
                              "why": "the arc-sharded cell, small"})
    for metric in spec["per_layer"] + spec["end_to_end"]:
        if CELL in metric.get("workloads", ()):
            metric["workloads"].append(TINY)
    (path / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, bench


def _run(bench, trace_on, seconds):
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT),
               **{harness.ENV_DEVICE: "cpu"})
    proc = subprocess.run(
        [sys.executable, str(bench / "run.py"), "--workload", TINY,
         "--seed", str(2 ** 31 + 23), "--seconds", str(seconds),
         "--trace", str(trace_on)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_arc_sharded_entry_runs_correct_on_four_ranks(tree):
    spec, _ = tree
    result = _run(tree[1], 0, 1.0)
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["count"] == 4
    assert result["ranks"]["calls"] == [result["attempted"]] * 4
    assert set(result["metrics"]) == {
        m["name"] for m in spec["end_to_end"] if harness.applies(m, TINY)}
    assert {"setup_s", "solve_ms"} <= set(result["metrics"])
    assert set(result["checks"]) == set(FUSED)


def test_a_traced_arc_sharded_run_counts_its_folds(tree):
    """On the CPU no kernel is traced: the one program counter reads, 4k
    + 1 collectives a solve with its x gather."""
    result = _run(tree[1], 1, 0.3)
    assert result["correct"] is True
    assert result["metrics"]["folds_per_solve"]["value"] == 4 * K + 1
    assert set(result["metrics"]) <= set(READERS)
