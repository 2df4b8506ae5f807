"""The port's experiment CLIs (``two_pass_lanczos_tpu_torch/experiments``)
against the JAX package's, on the CPU.

Each test runs the port CLI's ``main(argv + ["--torch-device", "cpu"])`` and
the JAX CLI's ``main(argv)`` with the same argv (``--cpu-f64`` or
``--backend xla``; never JAX's fused backend, whose interpret mode is
slow), at tiny sizes, and compares the CSVs:

* the header, column for column, and the k or n grid;
* the f64 accuracy columns (stability, orthogonality, the certificate
  study, the reorth study in f64) within rtol 1e-8 of JAX's. The two
  packages sum their dots in different orders, so a quantity that is
  rounding error itself (a deviation between two f64 solutions, the
  orthogonality loss of a basis that keeps it, an error past
  convergence) is held to an absolute floor instead: ``NOISE`` below;
* ``basis_drift_fro`` exactly 0: pass two replays pass one bit for bit;
* the memory columns: rss_kb > 0 and device_peak_kb == 0 on the CPU.
"""

import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu_torch.experiments import common

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--torch-device", "cpu"]
#: the absolute floor of a column that is f64 rounding error (relative
#: quantities of order one at most; n·k·ε with n ≤ 300, k ≤ 30 is ~2e-12)
NOISE = 1e-11
PORT = "two_pass_lanczos_tpu_torch.experiments"
JAX = "two_pass_lanczos_tpu.experiments"


def _read(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:]


def _both(name, argv, tmp_path):
    """(header, rows) of the port CLI and of the JAX CLI on ``argv`` (its
    ``--output`` added)."""
    import importlib

    out = {}
    for pkg, extra in (("port", CPU), ("jax", [])):
        path = tmp_path / f"{pkg}_{name}.csv"
        mod = importlib.import_module(f"{PORT if pkg == 'port' else JAX}.{name}")
        assert mod.main([*argv, "--output", str(path), *extra]) == 0
        out[pkg] = _read(path)
    assert out["port"][0] == out["jax"][0]  # the header, column for column
    return out["port"], out["jax"]


def _columns(header, rows):
    return {h: np.array([float(r[i]) for r in rows])
            for i, h in enumerate(header)}


def _close(port, jax, rtol=1e-8, atol=NOISE):
    np.testing.assert_allclose(port, jax, rtol=rtol, atol=atol)


# --- the shared plumbing ------------------------------------------------------

def test_timed_solve_repeats():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(8)

    out, dt = common.timed_solve(fn, repeats=5)
    assert len(calls) == 5 and torch.equal(out, torch.ones(8))
    assert isinstance(dt, common.SolveSeconds) and len(dt.samples) == 5
    assert dt.min_s <= float(dt) <= max(dt.samples)
    assert float(dt) == float(np.median(dt.samples))
    _, dt1 = common.timed_solve(fn)
    assert len(dt1.samples) == 1 and float(dt1) == dt1.min_s


def test_cpu_memory_columns_and_backend():
    cpu = torch.device("cpu")
    common.reset_peak_memory(cpu)  # nothing to reset on the CPU
    assert common.peak_memory_kb(cpu) > 0  # VmPeak
    assert common.device_peak_kb(cpu) == 0
    assert common.resolve_backend("auto", cpu) == "xla"
    assert common.resolve_backend("pallas", cpu) == "pallas"
    assert common.KKT_BACKENDS == {"pallas": "cuda", "xla": "auto"}


#: a valid argv of every CLI, without --output
ARGV = {
    "tradeoff": ["--arcs", "500", "--k-start", "4", "--k-end", "4"],
    "scalability": ["--arcs-start", "500", "--arcs-end", "500", "--k", "4"],
    "stability": ["--function", "inv", "--scenario", "well-conditioned",
                  "--size", "50", "--k-min", "4", "--k-max", "4"],
    "orthogonality": ["--function", "inv", "--scenario", "well-conditioned",
                      "--size", "50", "--k-min", "4", "--k-max", "4"],
    "certificate_study": ["--size", "50", "--k", "6"],
    "reorth_study": ["--function", "inv", "--scenario", "well-conditioned",
                     "--size", "50", "--k-min", "4", "--k-max", "4"],
    "dense_tradeoff": ["--size", "50", "--k-start", "4", "--k-end", "4"],
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_cli_defaults_to_the_card(name, tmp_path):
    """Without --torch-device a CLI runs on the card, and a CUDA device
    without a card raises: no silent CPU route."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default would run on it")
    import importlib

    mod = importlib.import_module(f"{PORT}.{name}")
    out = tmp_path / "x.csv"
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([*ARGV[name], "--output", str(out)])
    assert not out.exists()


# --- tradeoff, scalability, dense_tradeoff -----------------------------------

def _memory_and_grid(port, jax, key_cols):
    (header, prow), (_, jrow) = port, jax
    assert [r[:key_cols] for r in prow] == [r[:key_cols] for r in jrow]
    assert {r[0] for r in prow} == {"standard", "two-pass"}
    rss, dev = header.index("rss_kb"), header.index("device_peak_kb")
    for r in prow:
        assert int(r[rss]) > 0 and int(r[dev]) == 0
        t_med, t_min = float(r[header.index("time_s")]), float(
            r[header.index("time_min_s")])
        assert 0 < t_min <= t_med
    for r in jrow:
        assert int(r[dev]) == 0


def _inline_jax_workers(monkeypatch):
    """Run the JAX CLI's ``--isolate`` workers in this process: its
    orchestrator's ``run_orchestrated`` calls the CLI's ``main`` with the
    worker's variables set and reads its ``ROW,`` lines. (The JAX tradeoff
    CLI's in-process sweep raises a ``NameError`` on its unimported
    ``log``, and a worker process of its own takes ~10 s to start.)"""
    import contextlib
    import importlib
    import io

    from two_pass_lanczos_tpu.experiments import common as jcommon

    def run(argv, parse_row, k_values=None):
        mod = importlib.import_module(argv[0])
        rows = []
        for variant in jcommon.VARIANTS:
            for k in k_values if k_values is not None else [None]:
                monkeypatch.setenv(jcommon.VARIANT_ENV, variant)
                if k is not None:
                    monkeypatch.setenv(jcommon.K_ENV, str(k))
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    assert mod.main(argv[1:]) == 0
                rows += [parse_row(line[4:].split(","))
                         for line in buf.getvalue().splitlines()
                         if line.startswith("ROW,")]
        monkeypatch.delenv(jcommon.VARIANT_ENV)
        monkeypatch.delenv(jcommon.K_ENV, raising=False)
        return rows

    monkeypatch.setattr(jcommon, "run_orchestrated", run)


def test_tradeoff_isolated_matches_jax(tmp_path, monkeypatch):
    """``--isolate`` spawns one worker per (variant, k), 2 x len(k), and the
    CSV is the JAX CLI's: its header, its (variant, k) grid."""
    spawned = []
    real_run = subprocess.run

    def counting_run(cmd, **kwargs):
        env = kwargs.get("env") or {}
        if common.VARIANT_ENV in env:  # a worker, not another caller's run
            spawned.append((env[common.VARIANT_ENV], env[common.K_ENV]))
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(common.subprocess, "run", counting_run)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _inline_jax_workers(monkeypatch)
    port, jax = _both("tradeoff", [
        "--arcs", "2000", "--k-start", "4", "--k-end", "8", "--k-step", "4",
        "--repeats", "2", "--isolate", "--backend", "xla", "--cpu-f64"],
        tmp_path)
    assert sorted(spawned) == [("standard", "4"), ("standard", "8"),
                               ("two-pass", "4"), ("two-pass", "8")]
    assert port[0] == ["variant", "k", "time_s", "time_min_s", "rss_kb",
                       "device_peak_kb"]
    _memory_and_grid(port, jax, 2)
    assert [(r[0], r[1]) for r in port[1]] == [
        ("standard", "4"), ("standard", "8"), ("two-pass", "4"),
        ("two-pass", "8")]


@pytest.mark.parametrize("backend", ["fused", "pallas", "auto"])
def test_tradeoff_backends_on_the_cpu(backend, tmp_path):
    """The fused solver (f32) and the generic tier run the same grid on the
    CPU's plain versions; 'auto' is the generic operator there."""
    out = tmp_path / "t.csv"
    from two_pass_lanczos_tpu_torch.experiments.tradeoff import main

    assert main(["--arcs", "1000", "--k-start", "3", "--k-end", "6",
                 "--k-step", "3", "--backend", backend, "--output", str(out),
                 *CPU]) == 0
    header, rows = _read(out)
    assert [(r[0], r[1]) for r in rows] == [
        ("standard", "3"), ("standard", "6"), ("two-pass", "3"),
        ("two-pass", "6")]


def test_scalability_matches_jax_with_both_variants_at_every_n(tmp_path):
    port, jax = _both("scalability", [
        "--arcs-start", "1000", "--arcs-end", "2000", "--arcs-step", "1000",
        "--k", "8", "--backend", "xla", "--cpu-f64"], tmp_path)
    assert port[0] == ["variant", "n", "k", "time_s", "time_min_s", "rss_kb",
                       "device_peak_kb"]
    _memory_and_grid(port, jax, 3)
    # python/calculate_growth_rate.py indexes both variants at every n
    by_n = {}
    for r in port[1]:
        by_n.setdefault(int(r[1]), set()).add(r[0])
    assert len(by_n) == 2
    assert all(v == {"standard", "two-pass"} for v in by_n.values())


def test_dense_tradeoff_matches_jax(tmp_path):
    port, jax = _both("dense_tradeoff", [
        "--size", "120", "--k-start", "10", "--k-end", "20", "--k-step", "10",
        "--cpu-f64"], tmp_path)
    _memory_and_grid(port, jax, 2)


# --- a failed worker ----------------------------------------------------

def test_failed_worker_fails_the_orchestrator(tmp_path):
    """A worker that exits non-zero makes the orchestrator exit non-zero,
    with no CSV (the JAX CLI logs it and writes the rows it has)."""
    out = tmp_path / "fail.csv"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tradeoff", "--dmx",
         str(tmp_path / "none.dmx"), "--qfc", str(tmp_path / "none.qfc"),
         "--k-start", "4", "--k-end", "4", "--isolate", "--output", str(out),
         *CPU],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert "WorkerError" in proc.stderr and "variant=standard" in proc.stderr
    assert not out.exists()


# --- stability, orthogonality ------------------------------------------------

SCENARIOS = [("exp", "well-conditioned"), ("exp", "ill-conditioned"),
             ("inv", "well-conditioned"), ("inv", "ill-conditioned")]


@pytest.mark.parametrize("f,scenario", SCENARIOS)
def test_stability_matches_jax_in_f64(f, scenario, tmp_path):
    port, jax = _both("stability", [
        "--function", f, "--scenario", scenario, "--size", "300",
        "--k-min", "6", "--k-max", "30", "--k-step", "12", "--cpu-f64"],
        tmp_path)
    p, j = _columns(*port), _columns(*jax)
    assert list(p["k"]) == list(j["k"]) == [6, 18, 30]
    for col in ("relative_error_standard", "relative_error_two_pass"):
        _close(p[col], j[col])
    assert np.all(p["relative_solution_deviation"] <= NOISE)


@pytest.mark.parametrize("f,scenario", [("inv", "ill-conditioned"),
                                        ("exp", "well-conditioned")])
def test_stability_df_matches_jax(f, scenario, tmp_path):
    port, jax = _both("stability", [
        "--function", f, "--scenario", scenario, "--size", "200",
        "--k-min", "10", "--k-max", "20", "--k-step", "10",
        "--precision", "df"], tmp_path)
    p, j = _columns(*port), _columns(*jax)
    for col in ("relative_error_standard", "relative_error_two_pass"):
        _close(p[col], j[col])
    assert np.all(p["relative_solution_deviation"] <= NOISE)


@pytest.mark.parametrize("f,scenario", [("inv", "ill-conditioned"),
                                        ("exp", "well-conditioned")])
def test_orthogonality_matches_jax_with_zero_drift(f, scenario, tmp_path):
    port, jax = _both("orthogonality", [
        "--function", f, "--scenario", scenario, "--size", "300",
        "--k-min", "10", "--k-max", "40", "--k-step", "15", "--cpu-f64"],
        tmp_path)
    p, j = _columns(*port), _columns(*jax)
    assert list(p["k"]) == list(j["k"]) == [10, 25, 40]
    assert np.all(p["basis_drift_fro"] == 0.0)
    for col in ("ortho_loss_standard", "ortho_loss_regenerated"):
        _close(p[col], j[col])
    assert np.array_equal(p["ortho_loss_standard"],
                          p["ortho_loss_regenerated"])
    assert np.all(p["solution_deviation_l2"] <= NOISE)


# --- the studies and datagen ---------------------------------------------------

def test_certificate_study_matches_jax(tmp_path):
    port, jax = _both("certificate_study", [
        "--size", "128", "--k", "24", "--stride", "3"], tmp_path)
    p, j = _columns(*port), _columns(*jax)
    assert list(p["j"]) == list(j["j"]) == list(range(1, 24, 3))
    for col in ("lower_bound", "upper_bound", "true_error_a_norm",
                "lagged_update_estimate"):
        _close(p[col], j[col])
    # the bracket encloses the true error
    assert np.all(p["lower_bound"] <= p["true_error_a_norm"] * (1 + 1e-8))
    assert np.all(p["true_error_a_norm"] <= p["upper_bound"] * (1 + 1e-8))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_reorth_study_matches_jax(dtype, tmp_path):
    port, jax = _both("reorth_study", [
        "--function", "inv", "--scenario", "ill-conditioned", "--size",
        "200", "--k-min", "20", "--k-max", "60", "--k-step", "20",
        "--dtype", dtype], tmp_path)
    p, j = _columns(*port), _columns(*jax)
    assert list(p["k"]) == list(j["k"]) == [20, 40, 60]
    if dtype == "f64":
        for col in ("relative_error_plain", "relative_error_reorth",
                    "relative_error_selective"):
            _close(p[col], j[col])
        assert np.array_equal(p["reorth_steps_selective"],
                              j["reorth_steps_selective"])
    # tests/test_reorth.py's contract: CGS2 keeps the basis orthonormal to
    # working precision, the selective run semi-orthogonal
    bound = 5e-6 if dtype == "f32" else 1e-12
    assert np.all(p["ortho_defect_reorth"] < bound)
    assert np.all(p["ortho_defect_selective"] < np.sqrt(bound))


def test_datagen_python_writes_the_jax_bytes(tmp_path):
    from two_pass_lanczos_tpu.experiments.datagen import main as jax_main
    from two_pass_lanczos_tpu_torch.experiments.datagen import main

    argv = ["--arcs", "3000", "--rho", "2", "--instance-id", "4",
            "--fixed-cost", "b", "--scaling", "s", "--python"]
    assert main([*argv, "--output-dir", str(tmp_path / "port")]) == 0
    assert jax_main([*argv, "--output-dir", str(tmp_path / "jax")]) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["netgen-3000-2-4-b-a-s.dmx", "netgen-3000-2-4-b-a-s.qfc"]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
