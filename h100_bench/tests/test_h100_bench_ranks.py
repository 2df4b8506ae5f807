"""A cell of D > 1 ranks on the CPU, through ``run.py`` in a subprocess:
one process a rank over gloo, rank 0's result line, the ranks' calls in
step, the faults that have to end every rank with no result, the fold of
the ranks' readings, and the one-card path that forms no group and starts
no process."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from h100_bench import harness, ranks
from h100_bench.tests.tiny import SHARDED, tiny_tree

#: each run's limit, far above the ~10 s a run takes here
RUN_LIMIT_S = 240
SEED = 2 ** 31 + 19


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _run(tree, tmp_path, cell, fault=None, trace=0, seconds=1.0):
    """``run.py`` of the tree on ``cell``; returns the process, the time it
    ended and the pids of the ranks it started."""
    _, bench = tree
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT),
               TINY_DIR=str(tmp_path), **{harness.ENV_DEVICE: "cpu"})
    env.pop("TINY_FAULT", None)
    if fault:
        env["TINY_FAULT"] = fault
    proc = subprocess.run(
        [sys.executable, str(bench / "run.py"), "--workload", cell,
         "--seed", str(SEED), "--seconds", str(seconds),
         "--trace", str(trace)],
        env=env, capture_output=True, text=True, timeout=RUN_LIMIT_S)
    ended = time.time()
    pids = [int(w) for line in proc.stderr.splitlines()
            if line.startswith("ranks spawned ") for w in line.split()[2:]]
    return proc, ended, pids


def _result_lines(stdout: str):
    return [line for line in stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("cell", sorted(SHARDED))
def test_a_multi_rank_cell_runs_through_run_py(tree, tmp_path, cell):
    world = SHARDED[cell]
    proc, _, pids = _run(tree, tmp_path, cell)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = _result_lines(proc.stdout)
    assert lines == proc.stdout.strip().splitlines()[-1:]
    result = json.loads(lines[0])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["count"] == world
    assert list(result)[-1] == "checks"
    assert len(pids) == world - 1
    assert not any(_alive(p) for p in pids)
    err = proc.stderr.strip().splitlines()
    phases = next(ln for ln in err if ln.startswith("setup_s ")).split()
    assert phases[1:5:2] == ["imports", "ranks"]
    assert err[-1].startswith("check ")
    # every rank made the same calls: the counting entry's and the fold's
    counted = [int((tmp_path / f"calls.{r}").read_text())
               for r in range(world)]
    warmup = harness.load_json(tree[1] / "traffic" / "tiny_sharded.json")[
        "warmup_solves"]
    assert counted == [warmup + result["attempted"]] * world
    assert result["ranks"]["world"] == world
    assert result["ranks"]["calls"] == [result["attempted"]] * world


def test_a_traced_multi_rank_run_reads_rank_0(tree, tmp_path):
    proc, _, _ = _run(tree, tmp_path, "tiny.sharded2", trace=1, seconds=0.3)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(_result_lines(proc.stdout)[0])
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"]["launches_per_solve"]["value"] >= 0


@pytest.mark.parametrize("fault,timed", [
    ("build", True), ("window", True), ("killed", True),
    ("forbidden", False), ("checksum", False)])
def test_a_faulty_rank_ends_the_run_with_no_result(tree, tmp_path, fault,
                                                   timed):
    proc, ended, pids = _run(tree, tmp_path, "tiny.sharded2", fault=fault)
    assert proc.returncode != 0
    assert _result_lines(proc.stdout) == []
    assert "no result" in proc.stderr
    assert len(pids) == 1 and not _alive(pids[0])
    struck = float((tmp_path / "fault").read_text())
    if timed:
        assert ended - struck < ranks.FAULT_S
    if fault == "forbidden":
        assert "rank 1 loaded jax" in proc.stderr


def test_four_ranks_end_when_one_is_killed(tree, tmp_path):
    proc, ended, pids = _run(tree, tmp_path, "tiny.sharded4", fault="killed")
    assert proc.returncode != 0 and _result_lines(proc.stdout) == []
    assert len(pids) == 3 and not any(_alive(p) for p in pids)
    assert ended - float((tmp_path / "fault").read_text()) < ranks.FAULT_S


def test_the_fold_of_the_ranks_readings():
    names = harness.FORBIDDEN
    folded = ranks.fold([[10, 30, 7, 0], [50, 20, 7, 0], [5, 40, 7, 0]],
                        names)
    assert folded["window_peak"] == 40
    assert folded["memory_peak"] == 50
    assert folded["calls"] == [7, 7, 7] and folded["same_calls"]
    assert ranks.fault_of(folded) is None
    uneven = ranks.fold([[0, 0, 7, 0], [0, 0, 6, 0]], names)
    assert not uneven["same_calls"]
    assert "different numbers of calls" in ranks.fault_of(uneven)
    loaded = ranks.fold([[0, 0, 7, 0], [0, 0, 7, 0b101]], names)
    assert loaded["forbidden"] == {1: ["jax", "flax"]}
    assert ranks.fault_of(loaded) == "rank 1 loaded jax, flax"


def test_the_mask_names_what_the_guard_finds(monkeypatch):
    assert harness.forbidden_mask() == 0
    monkeypatch.setitem(sys.modules, "flax.fake_sub", object())
    assert harness.forbidden_mask() == 1 << harness.FORBIDDEN.index("flax")


def test_the_checksum_reads_every_bit():
    b = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    c = b.clone()
    c[500] = torch.nextafter(c[500], torch.tensor(float("inf")))
    assert ranks.checksum(b) == ranks.checksum(b.clone())
    assert ranks.checksum(b) != ranks.checksum(c)
    assert ranks.checksum(b) != ranks.checksum(b.flip(0))


def test_the_one_card_path_forms_no_group_and_starts_no_process(
        tree, monkeypatch, capsys):
    def no_process(*args, **kwargs):
        raise AssertionError("a one-card run started a process")

    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setenv(harness.ENV_DEVICE, "cpu")
    rc = harness.main(["--workload", "tiny.two_pass", "--seed", str(SEED),
                       "--seconds", "0.3"], bench=tree[1])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["count"] == 1
    assert "ranks" not in result
    assert not dist.is_initialized()

