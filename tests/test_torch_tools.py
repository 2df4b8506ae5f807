"""The port's measurement tools on the CPU: ``utils/perf.py`` against the
JAX package's, the K7 speed-of-light record's keys (on K7's plain
version), and the distributed tools over gloo ranks: ``scaling_bench``
(the record schema of ``tests/test_multihost.py``), ``multihost_smoke``
(against the single-process oracle ‖b‖) and ``collective_audit`` (the
per-step collectives that ``tests/test_torch_sharded*.py`` pin)."""

import json

import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu_torch.tools._spawn import free_port, spawn_ranks


# --- utils/perf.py ------------------------------------------------------------

def test_perf_matches_jax_on_the_cpu():
    from two_pass_lanczos_tpu.utils import perf as jperf
    from two_pass_lanczos_tpu_torch.utils import perf

    j = jperf.get_peak_rss_kb()
    p = perf.get_peak_rss_kb()
    assert 0 < j <= p  # the same VmPeak, read later
    assert perf.device_memory_stats("cpu") == jperf.device_memory_stats() == {}
    assert perf.live_device_bytes("cpu") == 0
    perf.reset_peak_memory("cpu")
    assert perf.card_description("cpu") == "cpu"
    with perf.Timer() as t:
        y = torch.ones(4) * 2
        t.block_on(y, (y, [y]))
    assert t.elapsed > 0
    with jperf.Timer() as jt:
        jt.block_on(np.ones(4))
    assert jt.elapsed > 0


def test_perf_exports_the_jax_names():
    from two_pass_lanczos_tpu import utils as jutils
    from two_pass_lanczos_tpu_torch import utils

    for name in ("get_peak_rss_kb", "device_memory_stats", "Timer"):
        assert name in utils.__all__ and name in jutils.__all__
    if not torch.cuda.is_available():
        assert utils.device_memory_stats() == {}


# --- sol_bench -----------------------------------------------------------------

#: the record keys of scripts/sol_bench.py
JAX_SOL_KEYS = {"metric", "seconds_per_matvec", "gnnz_per_s",
                "layout_bytes_per_matvec", "ideal_bytes_per_matvec",
                "sol_fraction_layout", "sol_fraction_ideal",
                "effective_gb_per_s", "pad_ratio", "windowed", "timing"}


def test_sol_bench_record_on_the_plain_k7(capsys):
    from two_pass_lanczos_tpu.observability import kkt_spmv_sol
    from two_pass_lanczos_tpu_torch.models.generator import nodes_for
    from two_pass_lanczos_tpu_torch.tools.sol_bench import main

    assert main(["--arcs", "2000", "5000", "--lo", "2", "--hi", "6",
                 "--reps", "2", "--torch-device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    recs, summary = lines[:-1], lines[-1]
    assert [r["metric"] for r in recs] == [
        "streaming_kkt_matvec_arcs2000_rho3",
        "streaming_kkt_matvec_arcs5000_rho3"]
    for arcs, r in zip((2000, 5000), recs):
        assert set(r) == JAX_SOL_KEYS | {"device", "card"}
        p = nodes_for(arcs, 3)
        # the function's bytes, the JAX package's ideal-layout bytes
        assert r["ideal_bytes_per_matvec"] == 20 * arcs + 8 * p == (
            kkt_spmv_sol(arcs, p, 1.0).bytes_per_matvec)
        # what K7 reads: the incidence CSR besides
        assert r["layout_bytes_per_matvec"] == 28 * arcs + 12 * p + 4
        assert r["pad_ratio"] == pytest.approx(
            r["layout_bytes_per_matvec"] / r["ideal_bytes_per_matvec"])
        assert r["windowed"] is False and r["device"] == "cpu"
        assert r["card"] == "cpu"
        # no device fraction from a CPU time
        assert r["sol_fraction_ideal"] is None
        assert r["sol_fraction_layout"] is None
        assert r["timing"]["lo"] == 2 and r["timing"]["hi"] == 6
        assert r["seconds_per_matvec"] != 0
    assert summary["best_sol_fraction_ideal"] is None


def test_sol_bench_refuses_the_windowed_gather():
    from two_pass_lanczos_tpu_torch.tools.sol_bench import main

    with pytest.raises(SystemExit):
        main(["--arcs", "2000", "--windowed", "--torch-device", "cpu"])


@pytest.mark.parametrize("tool", ["sol_bench", "scaling_bench"])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default would run on it")
    import importlib

    mod = importlib.import_module(f"two_pass_lanczos_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--arcs", "2000"])


# --- the distributed tools -------------------------------------------------------

def test_scaling_bench_two_gloo_processes(capsys, monkeypatch):
    """1- and 2-process sweeps on gloo print the record schema of
    tests/test_multihost.py for both designs; CPU ranks are never
    meaningful."""
    from two_pass_lanczos_tpu_torch.tools.scaling_bench import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert main(["--processes", "1", "2", "--arcs", "20000", "--k", "20",
                 "--reps", "1", "--torch-device", "cpu"]) == 0
    records = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    metrics = {r["metric"]: r for r in records if "metric" in r}
    assert set(metrics) == {f"scaling_{d}_nproc{n}"
                            for d in ("fused", "generic") for n in (1, 2)}
    for design in ("fused", "generic"):
        for nproc in (1, 2):
            r = metrics[f"scaling_{design}_nproc{nproc}"]
            assert r["seconds_per_step"] > 0 and r["nnz_per_s"] > 0
            assert r["ndev"] == nproc and r["meaningful"] is False
            assert r["arcs"] == 20000 and r["k"] == 20
            assert r["device"] == "cpu"
        assert metrics[f"scaling_{design}_nproc1"][
            "efficiency_vs_1proc"] == 1.0
    assert any("note" in r for r in records)


def test_multihost_smoke_two_gloo_processes(monkeypatch):
    from two_pass_lanczos_tpu_torch.tools.multihost_smoke import instance

    # the oracle: the fused dot counts each arc and each node once, so the
    # sharded ||b|| is the plain one
    bnorm = float(np.linalg.norm(instance()[4].astype(np.float64)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    port = free_port()
    ranks = spawn_ranks(
        "two_pass_lanczos_tpu_torch.tools.multihost_smoke", 2,
        lambda r: ["--num-processes", 2, "--process-id", r, "--coordinator",
                   f"localhost:{port}", "--expect-bnorm", repr(bnorm),
                   "--torch-device", "cpu"], timeout=120)
    for r in ranks:
        assert r.returncode == 0, r.stderr[-2000:]
    assert ranks[0].stdout.startswith("MULTIHOST_OK bnorm=")
    assert "steps=12" in ranks[0].stdout and ranks[1].stdout == ""


def test_multihost_smoke_refuses_a_wrong_oracle(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    port = free_port()
    ranks = spawn_ranks(
        "two_pass_lanczos_tpu_torch.tools.multihost_smoke", 1,
        lambda r: ["--num-processes", 1, "--process-id", r, "--coordinator",
                   f"localhost:{port}", "--expect-bnorm", "1.0",
                   "--torch-device", "cpu"], timeout=120)
    assert ranks[0].returncode != 0 and "oracle" in ranks[0].stderr
    assert "MULTIHOST_OK" not in ranks[0].stdout


def test_collective_audit_counts_and_bytes(capsys, monkeypatch):
    """The audit's per-step collectives are those the sharded tests pin
    (tests/test_torch_sharded.py, test_torch_sharded_sparse.py,
    test_torch_sharded_df.py), at D = 4 and k = 8."""
    from two_pass_lanczos_tpu_torch.models.generator import nodes_for
    from two_pass_lanczos_tpu_torch.tools.collective_audit import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    k, d, arcs = 8, 4, 2000
    assert main(["--arcs", str(arcs), "--k", str(k), "--ranks", "1", "2",
                 "4"]) == 0
    table, df, nnz, times = [json.loads(ln) for ln in
                             capsys.readouterr().out.splitlines()]
    p, rp, w = nodes_for(arcs, 3), table["rows_per"], table["fused_width"]

    def ops(rows):
        return [(o["kind"], o["dtype"], tuple(o["shape"]), o["count"])
                for o in rows]

    assert table["ranks"] == d and table["instance"]["nodes"] == p
    assert ops(table["fused_collectives"]) == [
        ("all-gather", "f32", (d,), 2 * k + 1),      # |b|, alpha, beta²
        ("all-gather", "f32", (d, p), 2 * k - 1),    # a matvec each
        ("all-gather", "f32", (d, w), 1)]            # x, once
    assert ops(table["generic_collectives"]) == sorted([
        ("all-gather", "f64", (d,), 2 * k + 1),
        ("all-gather", "f64", (d, rp), 1),
        ("all-gather-start", "f64", (d, rp), 2 * k - 1)])
    for o in table["fused_collectives"] + table["generic_collectives"]:
        size = 4 if o["dtype"] == "f32" else 8
        assert o["bytes_out"] == int(np.prod(o["shape"])) * size * o["count"]
    step = table["per_step_measured"]
    assert step["generic_all_gather_bytes"] == d * rp * 8
    assert step["fused_node_gather_bytes"] == d * p * 4
    assert step["ratio"] == pytest.approx(rp * 2 / p)
    # a row-sharded step: the gather in flight while the owned SpMV runs
    assert table["generic_events_head"][1:5] == [
        "all-gather-start", "owned-spmv", "all-gather-done", "remote-spmv"]
    assert ops(df["df_sharded"]) == [
        ("all-gather", "f32", (d, 2), 2 * k + 1),
        ("all-gather", "f32", (d, 2, p), 2 * k - 1),
        ("all-gather", "f32", (d, 2, w), 1)]
    assert df["df_all_reduce_count"] == 0
    assert sum(nnz["nnz_per_device"]) == 5 * arcs
    assert len(nnz["nnz_per_device"]) == d
    assert nnz["imbalance_max_over_mean"] < 1.02
    assert set(times["gloo_solve_s"]) == {"1", "2", "4"}
    assert all(t > 0 for t in times["gloo_solve_s"].values())


def test_spawned_ranks_are_killed_at_the_deadline():
    port = free_port()
    ranks = spawn_ranks("two_pass_lanczos_tpu_torch.tools.multihost_smoke", 2,
                        lambda r: ["--num-processes", 3, "--process-id", r,
                                   "--coordinator", f"localhost:{port}",
                                   "--torch-device", "cpu"], timeout=8)
    # the third rank never joins: both wait in the rendezvous and are
    # killed at the deadline, so no process outlives the call
    assert [r.returncode for r in ranks] == [-9, -9]


@pytest.mark.parametrize("dtype,name,size", [
    (torch.float32, "f32", 4), (torch.float64, "f64", 8),
    (torch.complex64, "c64", 8), (torch.complex128, "c128", 16)])
def test_collectives_record_each_dtype_at_its_bytes(dtype, name, size):
    """A complex gather is recorded under its own dtype and its true bytes
    (it moves its real view: two reals an element), so the audit's bytes
    stay right for a complex operator."""
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        collective_bytes,
        record_call,
        record_collectives,
    )

    with record_collectives() as log:
        for _ in range(3):
            record_call("all-gather-start", dtype, (4, 10))
    (op,) = log.ops()
    assert (op.kind, op.dtype, op.shape, op.count) == (
        "all-gather-start", name, (4, 10), 3)
    assert op.bytes_out == collective_bytes(log.ops()) == 3 * 40 * size
