"""Runs of the harness on the CPU at a small size: files found by name, the
result line, the check catching a broken program and the control, and the
run's guard against JAX."""

from __future__ import annotations

import dataclasses
import io
import json
import re
import subprocess
import sys

import pytest
import torch

from h100_bench import control, harness
from h100_bench.entries import fused, sparse
from h100_bench.tests.tiny import tiny_tree

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, trace=False, entry=None, seconds=0.3):
    spec, bench = tree
    return harness.run_cell(spec, cell, 2 ** 31 + 11, seconds, trace,
                            device="cpu", entry=entry, bench=bench,
                            log=io.StringIO())


def test_manifest_keeps_to_the_contract():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for name in names + cells + metrics:
        assert NAME.match(name), name
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in spec["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert harness.load_json(harness.ROOT / c["file"])["name"] == c["name"]
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    four = [w["name"] for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)
    for w in spec["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert any(harness.applies(m, w["name"]) for m in spec["per_layer"])


def test_every_named_file_is_found():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cfg = harness.load_json(harness.BENCH / "configs"
                                / f"{w['config']}.json")
        traffic = harness.load_json(harness.BENCH / "traffic"
                                    / f"{w['traffic']}.json")
        harness.load_json(harness.BENCH / "limits" / f"{w['name']}.json")
        harness.module("generators", cfg["generator"])
        harness.module("references", cfg["reference"])
        entry = harness.module("entries", traffic["entry"])
        for fn in ("build", "solve", "traced", "counters"):
            assert callable(getattr(entry, fn))
    for m in spec["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read)


@pytest.mark.parametrize("mix", ["two_pass", "one_pass", "sparse"])
def test_a_new_cell_runs_from_new_files_alone(tree, mix):
    result = _run(tree, f"tiny.{mix}")
    assert list(result)[:5] == CONTRACT_KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    spec, _ = tree
    assert set(result["metrics"]) == {
        m["name"] for m in spec["end_to_end"]
        if harness.applies(m, f"tiny.{mix}")}
    assert {"setup_s", "peak_mem_mb"} <= set(result["metrics"])
    assert ("solve_p95_ms" in result["metrics"]) == (mix != "sparse")
    assert ("solve_ms" in result["metrics"]) == (mix != "sparse")
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(result)


def test_a_new_metric_file_is_read_in_the_traced_run(tree):
    spec, bench = tree
    (bench / "metrics" / "tiny_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.solves))\n")
    spec = dict(spec, per_layer=spec["per_layer"] + [
        {"name": "tiny_count", "unit": "solves", "better": "lower",
         "source": "device_trace", "layer": "entry", "moves": "solve_ms",
         "workloads": ["tiny.two_pass"]}])
    result = harness.run_cell(spec, "tiny.two_pass", 5, 0.2, True,
                              device="cpu", bench=bench, log=io.StringIO())
    assert result["metrics"]["tiny_count"] == {"value": 2.0,
                                               "unit": "solves"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["correct"] is True


def test_the_sparse_cells_per_layer_metrics_are_read_in_the_traced_run(
        tree):
    spec, bench = tree
    result = harness.run_cell(spec, "tiny.sparse", 5, 0.3, True,
                              device="cpu", bench=bench, log=io.StringIO())
    wanted = {m["name"] for m in spec["per_layer"]
              if harness.applies(m, "tiny.sparse")}
    assert {"generic_solve_ms", "launches_per_solve.sparse",
            "f_tk_ms.sparse"} <= wanted
    # a CPU trace has no device events: the launches read 0, the device
    # times nothing
    assert set(result["metrics"]) == {"generic_solve_ms",
                                      "launches_per_solve.sparse"}
    assert result["metrics"]["generic_solve_ms"]["value"] > 0
    assert result["correct"] is True


def test_the_checks_end_standard_error(tree):
    spec, bench = tree
    log = io.StringIO()
    result = harness.run_cell(spec, "tiny.two_pass", 3, 0.2, False,
                              device="cpu", bench=bench, log=log)
    lines = log.getvalue().strip().splitlines()
    assert lines[0].split()[:2] == ["setup_s", "context"]
    lines = lines[-len(result["checks"]):]
    for line, (name, c) in zip(lines, result["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"


class _Broken:
    """The fused or generic entry with its output spoiled where made."""

    def __init__(self, base, spoil):
        self.base, self.spoil = base, spoil
        self.build, self.traced = base.build, base.traced
        self.counters = base.counters

    def solve(self, system, b, traffic):
        return self.spoil(self.base.solve(system, b, traffic))


def _scaled(out):
    return dataclasses.replace(out, x=out.x * 1.5)


def _one_entry(out):
    x = out.x.clone()
    x[0] += 10 * float(x.abs().max())
    return dataclasses.replace(out, x=x)


def _half_left_out(out):
    x = out.x.clone()
    x[x.shape[0] // 2:] = 0
    return dataclasses.replace(out, x=x)


def _alpha(out):
    a = out.alphas.clone()
    a[3] *= 1 + 1e-3
    return dataclasses.replace(out, alphas=a)


def _steps(out):
    return dataclasses.replace(out, steps=out.steps - 1)


def _bnorm(out):
    return dataclasses.replace(out, b_norm=out.b_norm * (1 + 1e-5))


@pytest.mark.parametrize("mix,spoil", [
    ("two_pass", _scaled), ("two_pass", _one_entry),
    ("two_pass", _half_left_out), ("two_pass", _alpha),
    ("two_pass", _steps), ("two_pass", _bnorm), ("one_pass", _half_left_out),
    ("one_pass", _alpha), ("one_pass", _bnorm), ("sparse", _scaled), ("sparse", _one_entry),
    ("sparse", _half_left_out)])
def test_a_broken_program_is_not_correct(tree, mix, spoil):
    base = sparse if mix == "sparse" else fused
    result = _run(tree, f"tiny.{mix}", entry=_Broken(base, spoil))
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("mix", ["two_pass", "sparse"])
def test_the_control_is_not_correct(tree, mix):
    spec, bench = tree
    limits = harness.load_json(bench / "limits" / f"tiny.{mix}.json")
    program, ctl = control.readings(spec, f"tiny.{mix}", [1, 2, 3], [1, 2, 3],
                                    "cpu", bench=bench, emit=lambda s: None)
    assert harness.compare.judge(program, limits)[0] is True
    correct, failed, _ = harness.compare.judge(ctl, limits)
    assert correct is False and failed == 3


def test_without_a_card_the_run_fails_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "kkt500k.two_pass", "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "two_pass_lanczos_tpu_torchx", object())
    assert "two_pass_lanczos_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_sub", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_a_fresh_interpreter_with_the_reference_holds_no_jax_or_program():
    code = ("import sys; import h100_bench.references.kkt, "
            "h100_bench.generators.mcf, h100_bench.counts, "
            "h100_bench.compare; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'two_pass_lanczos_tpu', "
            "'two_pass_lanczos_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.requires_cuda
def test_one_run_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert harness.main(["--workload", "kkt500k.two_pass", "--seed", "7",
                         "--seconds", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
