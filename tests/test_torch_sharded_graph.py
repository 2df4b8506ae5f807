"""The arc-sharded f32 solve as the cell ``kkt5m.arc_sharded.4chip`` runs
it, on 4 gloo ranks (``tests/torch_ranks.py``): against the benchmark's
plain reference within the cell's limits, the whole x on the device
(``gather_x``), the spans of the sharded solve, and the collectives it
counts. The CUDA graphs of the card path are held to the eager solve in
``tests/test_torch_cuda.py``; here, where every pass runs eagerly, the
counts' bookkeeping for a graph is checked on its own."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_ranks import spawn
from h100_bench import compare
from h100_bench.generators import mcf
from h100_bench.harness import Rhs
from h100_bench.references import kkt
from two_pass_lanczos_tpu_torch.utils.collectives import (
    record_call,
    record_collectives,
    record_event,
    report_again,
    set_aside,
)

ROOT = Path(__file__).resolve().parents[1]
LIMITS = json.loads((ROOT / "h100_bench" / "limits"
                     / "kkt5m.arc_sharded.4chip.json").read_text())
#: the configuration's generator at 3,000 arcs, rho 3: at 4,000 even one
#: card's float32 solve leaves float64's α from step 29 of 40
INST = mcf.generate(3000, 3, 1)
D = INST.quad_costs.astype(np.float32)
ARRAYS = dict(d=D, u=INST.arc_u, v=INST.arc_v, p=INST.num_nodes)
K = 40
#: the harness's b for each seed (call 0 of its window's stream)
DRAWS = {seed: Rhs(seed, INST.num_arcs + INST.num_nodes,
                   torch.device("cpu"))(0).numpy()
         for seed in (2 ** 31 + 7, 12345, 987654321)}
#: the breakdown tolerance of the configuration (1000·ε of float32)
TOL = 1000 * float(np.finfo(np.float32).eps)
SMALL = dict(ARRAYS, b=np.random.default_rng(3).standard_normal(
    INST.num_arcs + INST.num_nodes).astype(np.float32))
KS = 12


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    cases = [("draws", "gathered_solves", dict(ARRAYS, k=K, bs=DRAWS)),
             ("gather", "gather_x", dict(SMALL, k=KS, nf=0)),
             ("gather_nf", "gather_x", dict(SMALL, k=KS, nf=2)),
             ("spans", "spans", dict(SMALL, k=KS)),
             ("counts", "counts", dict(SMALL, k=KS))]
    return spawn(4, cases, tmp_path_factory.mktemp("graph4"))


def test_sharded_solve_within_the_cells_limits(ranks4):
    """The harness's b for each seed, solved on 4 ranks and gathered on
    the device, against the plain float64 reference: every number the
    cell compares within the cell's limit, and every rank's answer the
    same bits."""
    matrix = kkt.KKTMatrix(D, INST.arc_u, INST.arc_v, INST.num_nodes, "cpu")
    per_solve = []
    for seed, b in DRAWS.items():
        got = ranks4[0]["draws"][seed]
        for other in ranks4[1:]:
            assert np.array_equal(other["draws"][seed]["x"], got["x"])
            assert np.array_equal(other["draws"][seed]["alphas"],
                                  got["alphas"])
        ref = kkt.solve(matrix, torch.from_numpy(b).double(), K, "inv", TOL)
        nums = compare.numbers(compare.host_output(_output(got)), ref)
        per_solve.append(nums)
    correct, failed, checks = compare.judge(per_solve, LIMITS)
    assert correct and failed == 0, checks
    assert set(checks) == set(LIMITS)


def _output(got):
    from h100_bench.entries import Output
    return Output(x=torch.from_numpy(got["x"]),
                  alphas=torch.from_numpy(got["alphas"]),
                  betas=torch.from_numpy(got["betas"]),
                  steps=torch.tensor(got["steps"]),
                  b_norm=torch.tensor(got["b_norm"]))


@pytest.mark.parametrize("key", ["gather", "gather_nf"])
def test_gather_x_is_unpack_on_the_device(ranks4, key):
    n = INST.num_arcs + INST.num_nodes
    for rank in ranks4:
        r = rank[key]
        assert r["device"] == "cpu"
        assert r["pair"].shape[-1] == n
        for other in ("local", "unpack", "solve"):
            assert np.array_equal(r["pair"], r[other]), other
        assert np.array_equal(r["pair"], ranks4[0][key]["pair"])


@pytest.mark.parametrize("solve, want", [
    ("two_pass", [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
                  ("tpl.f_tk", "tpl.solve"), ("tpl.pass_two", "tpl.solve"),
                  ("tpl.gather_x", "tpl.solve")]),
    ("raw", [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
             ("tpl.f_tk", "tpl.solve"), ("tpl.pass_two", "tpl.solve"),
             ("tpl.gather_x", None)]),
    ("one_pass", [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
                  ("tpl.f_tk", "tpl.solve"),
                  ("tpl.basis_product", "tpl.solve")]),
    ("callback", [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
                  ("tpl.f_tk", "tpl.solve"), ("tpl.pass_two", "tpl.solve")]),
])
def test_sharded_solve_spans_nest_in_the_solve(ranks4, solve, want):
    for rank in ranks4:
        assert rank["spans"][solve] == want


@pytest.mark.parametrize("how", ["whole", "raw"])
def test_a_solve_with_its_x_gather_counts_4k_plus_1_collectives(ranks4,
                                                                how):
    """‖b‖, three folds a step of pass one (the product, α, β), one a
    step of pass two's k − 1 products, and the gather of x."""
    for rank in ranks4:
        c = rank["counts"][how]
        assert c["collectives"] == {"all-gather": 4 * KS + 1,
                                    "all-gather-start": 0}
        assert c["launches"] == {}  # the CPU runs K7's plain version


@pytest.mark.parametrize("how", ["whole", "raw"])
def test_the_count_agrees_with_an_open_log(ranks4, how):
    for rank in ranks4:
        c = rank["counts"][how]
        assert len(c["calls"]) == sum(c["collectives"].values())
        assert c["events"] == ["all-gather"] * len(c["calls"])
        world, p = rank["counts"]["world"], rank["counts"]["p"]
        shapes = [shape for _, _, shape in c["calls"]]
        assert shapes.count((world, p)) == 2 * KS - 1  # the node folds
        assert shapes.count((world,)) == 2 * KS + 1  # ‖b‖, α and β
        assert shapes[-1] == (world, rank["counts"]["width"])  # x


def test_a_set_aside_log_is_reported_again_in_order():
    """A graph's capture records its calls apart from the open logs; each
    replay reports them to the logs open then."""
    with record_collectives() as outer:
        record_call("all-gather", torch.float32, (4, 3))
        with set_aside() as inner:
            record_call("all-gather", torch.float32, (4,))
            record_event("all-gather-done")
        assert outer.calls == [("all-gather", "f32", (4, 3))]
        assert inner.calls == [("all-gather", "f32", (4,))]
        assert inner.events == ["all-gather", "all-gather-done"]
        report_again(inner)
        report_again(inner)
    assert outer.calls == [("all-gather", "f32", (4, 3))] + [
        ("all-gather", "f32", (4,))] * 2
    assert outer.events == ["all-gather"] + [
        "all-gather", "all-gather-done"] * 2
    record_call("all-gather", torch.float32, (2,))  # no log open: no error
    assert len(outer.calls) == 3
