"""The yardstick: the frozen generator, the plain reference, the counts and
the reduction of a trace, each held to an independent source."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from h100_bench import counts, trace
from h100_bench.generators import mcf
from h100_bench.metrics import (f_tk_ms, launches_per_solve,
                                pass_one_ms, pass_one_roofline,
                                pass_two_roofline, spmv_ms, spmv_roofline,
                                device_idle_pct, basis_product_ms)
from h100_bench.references import kkt


@pytest.mark.parametrize("arcs,rho,iid,cf,cq,scaling", [
    (500, 3, 1, "a", "a", "ns"), (2_000, 1, 4, "b", "a", "s"),
    (7_919, 2, 2, "a", "b", "ns"), (20_000, 3, 1, "a", "a", "ns")])
def test_generator_is_bitwise_the_programs(arcs, rho, iid, cf, cq, scaling):
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance)
    want = generate_mcf_instance(arcs, rho, iid, cf, cq, scaling)
    got = mcf.generate(arcs, rho, iid, cf, cq, scaling)
    assert got.num_nodes == want.num_nodes == mcf.nodes_for(arcs, rho)
    assert got.num_arcs == want.num_arcs
    for name in ("arc_u", "arc_v", "quad_costs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_config_sizes_match_the_generator():
    assert mcf.nodes_for(500_000, 3) == 1155
    assert mcf.nodes_for(5_000_000, 3) == 3651


def _instance(arcs=3000):
    inst = mcf.generate(arcs, 3, 1)
    return inst._replace(quad_costs=inst.quad_costs.astype(np.float32))


def test_reference_matvec_is_the_dense_kkt_matrix():
    inst = _instance(400)
    m, p = inst.num_arcs, inst.num_nodes
    a = kkt.KKTMatrix(inst.quad_costs, inst.arc_u, inst.arc_v, p, "cpu")
    dense = np.zeros((m + p, m + p))
    dense[np.arange(m), np.arange(m)] = inst.quad_costs
    dense[m + inst.arc_u, np.arange(m)] += 1
    dense[m + inst.arc_v, np.arange(m)] -= 1
    dense[:m, m:] = dense[m:, :m].T
    x = np.random.default_rng(0).standard_normal(m + p)
    got = a.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, dense @ x, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("k", [5, 30])
def test_reference_agrees_with_the_programs_plain_f64_path(k):
    import two_pass_lanczos_tpu_torch as tpl
    inst = _instance()
    m, p = inst.num_arcs, inst.num_nodes
    b = torch.as_tensor(np.random.default_rng(k).standard_normal(m + p))
    ref = kkt.solve(kkt.KKTMatrix(inst.quad_costs, inst.arc_u, inst.arc_v,
                                  p, "cpu"), b, k, "inv", 0.0)
    op = tpl.make_kkt_operator(inst.quad_costs.astype(np.float64),
                               inst.arc_u, inst.arc_v, p, device="cpu")
    dec = tpl.lanczos_pass_one(op, b, k)
    np.testing.assert_allclose(ref.alphas, dec.alphas.numpy(), rtol=1e-9)
    np.testing.assert_allclose(ref.betas[:k - 1], dec.betas[:k - 1].numpy(),
                               rtol=1e-9)
    assert ref.steps == int(dec.steps_taken) == k
    assert ref.b_norm == pytest.approx(float(dec.b_norm), rel=1e-14)
    x = tpl.solve_fAb(op, b, k=k, f="inv").numpy()
    assert np.linalg.norm(ref.x - x) / np.linalg.norm(x) < 1e-8


def test_reference_stops_at_breakdown():
    # A = diag(d) on the arcs and a lone node: b in a 2-d invariant space
    d = np.array([2.0, 3.0, 2.0, 3.0])
    a = kkt.KKTMatrix(d, [0, 0, 0, 0], [1, 1, 1, 1], 2, "cpu")
    b = torch.zeros(6, dtype=torch.float64)
    b[0] = 1.0
    r = kkt.solve(a, b, 5, "inv", 1e-10)
    assert r.steps < 5 and np.all(r.alphas[r.steps:] == 0)
    np.testing.assert_allclose(
        a.matvec(torch.as_tensor(r.x)).numpy(), b.numpy(), atol=1e-10)


def test_round_tf32_keeps_ten_mantissa_bits_ties_to_even():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 4,
                      -(one + 0.75 * ulp), 3.0], dtype=torch.float32)
    want = [one, one + 2 * ulp, one, -(one + ulp), 3.0]
    assert kkt.round_tf32(x).tolist() == want


def test_counts_match_hand_sums():
    m, p = 10, 4
    n = m + p
    assert counts.kkt_matvec(m, p) == (3 * m + 2 * m, 4 * 3 * m + 4 * n * 2)
    ops, nbytes = counts.pass_one(m, p, 3)
    assert ops == 3 * n + 3 * (5 * m + 2 * n + 2 * n + 2 * n + 2 * n + n)
    assert nbytes == 4 * m * 3 + 4 * n + 4 * 3 + 4 * 3 + 4 + 4
    assert counts.pass_one(m, p, 3, basis=True)[1] == nbytes + 3 * n * 4
    ops, nbytes = counts.pass_two(m, p, 3)
    assert ops == n + 3 * 2 * n + 2 * (5 * m + 2 * n + 2 * n + n)
    assert nbytes == 4 * 3 * m + 4 * n + 3 * 4 * 3 + 4 * n
    assert counts.basis_product(n, 3) == (2 * 3 * n, 4 * 3 * n + 12 + 4 * n)
    assert counts.kkt_nnz(m) == m + 2 * m + 2 * m
    assert counts.coo_spmv(n, 50) == (100, 50 * 8 + 4 * (n + 1) + 8 * n)
    peak = {"f32_flops": 10.0, "hbm_bytes_per_s": 100.0}
    assert counts.least_seconds(20, 100, peak) == 2.0
    assert counts.least_seconds(5, 300, peak) == 3.0


def test_busy_is_the_union_of_intervals():
    assert trace.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.busy_us([]) == 0.0


def _raw():
    """Two solves: a K2, a small kernel and a K3 each, and a generic
    solve's products inside ``bench.spmv`` spans; launches by correlation."""
    host = [("bench.solve", 0.0, 100.0, 1, 0),
            ("cudaLaunchCooperativeKernel", 1.0, 2.0, 501, 0),
            ("aten::linalg_solve", 50.0, 52.0, 2, 0),
            ("cudaLaunchKernel", 50.5, 51.0, 502, 0),
            ("cudaLaunchCooperativeKernel", 53.0, 54.0, 503, 0),
            ("bench.solve", 200.0, 300.0, 3, 0),
            ("bench.spmv", 201.0, 202.0, 4, 0),
            ("cudaLaunchKernel", 201.5, 201.8, 504, 0),
            ("cudaLaunchKernel", 202.5, 202.7, 508, 0),
            ("bench.spmv", 203.0, 204.0, 5, 0),
            ("cudaLaunchKernel", 203.5, 203.8, 505, 0),
            ("cudaLaunchKernel", 205.0, 205.2, 506, 0),
            ("bench.spmv", 206.0, 207.0, 6, 0),
            ("cudaLaunchKernel", 206.5, 206.8, 507, 0),
            ("bench.draw", 150.0, 160.0, 7, 0)]
    dev = [  # (name, start, end, id, link): the device clock runs early
        ("void pass_one_persistent_kernel<false>", -0.5, 40.0, 501, 0),
        ("getrf_pivot", 50.9, 52.9, 502, 0),
        ("pass_two_persistent_kernel(PassTwo)", 53.5, 90.0, 503, 0),
        ("bench.solve", 0.0, 100.0, 0, 0),
        ("segmented_reduce", 210.0, 220.0, 504, 0),
        ("axpy", 222.0, 223.0, 508, 0),
        ("segmented_reduce", 225.0, 235.0, 505, 0),
        ("tail", 236.0, 238.0, 506, 0),
        ("segmented_reduce", 240.0, 250.0, 507, 0),
        ("randn", 155.0, 156.0, 999, 0)]
    return dev, host


def test_reduce_assigns_events_by_their_launch():
    st = trace.reduce_events(*_raw())
    assert [len(s) for s in st.solves] == [3, 5]
    assert [ev.name[:4] for ev in st.solves[0]] == ["void", "getr", "pass"]
    assert st.window_us == 200.0
    # busy inside the spans: [0, 40] + [50.9, 52.9] + [53.5, 90] and the
    # second solve's 10 + 1 + 10 + 2 + 10; the draw's randn is in no solve
    assert st.busy_us == pytest.approx(40 + 2 + 36.5 + 33)
    tagged = [ev.name for ev in st.solves[1] if "bench.spmv" in ev.spans]
    assert tagged == ["segmented_reduce"] * 3
    assert st.breakdown["device_ops"][0] == [
        "void pass_one_persistent_kernel<false>", 40.5e-6]
    assert len(st.breakdown["idle_gaps"]) <= 10


class _Ctx:
    def __init__(self, stretch, traffic, steps, peak, counters=None):
        self.stretch, self.solves = stretch, stretch.solves
        self.traffic, self.steps, self.peak = traffic, steps, peak
        self.counters = counters or {}
        self.call_ms = []
        self.m, self.p = 10, 4
        self.n = 14


def test_readers_on_a_known_stretch():
    st = trace.reduce_events(*_raw())
    fused = trace.Stretch([st.solves[0]], st.spans, 100.0, 78.5, {})
    generic = trace.Stretch([st.solves[1]], st.spans, 100.0, 33.0, {})
    peak = {"f32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    ctx = _Ctx(fused, {"method": "two_pass"}, [7], peak)
    assert launches_per_solve.read(ctx) == 3
    assert pass_one_ms.read(ctx) == pytest.approx(40.5e-3)
    assert f_tk_ms.read(ctx) == pytest.approx(2e-3)
    assert basis_product_ms.read(ctx) is None
    assert device_idle_pct.read(ctx) == pytest.approx(21.5)
    least = counts.least_seconds(*counts.pass_one(10, 4, 7), peak)
    assert pass_one_roofline.read(ctx) == pytest.approx(
        100 * least / 40.5e-6)
    least = counts.least_seconds(*counts.pass_two(10, 4, 7), peak)
    assert pass_two_roofline.read(ctx) == pytest.approx(
        100 * least / 36.5e-6)
    assert spmv_ms.read(ctx) is None
    gctx = _Ctx(generic, {"method": "two_pass"}, [], peak)
    assert spmv_ms.read(gctx) == pytest.approx(30e-3)
    # three products: the middle gap holds the tail between the passes
    assert f_tk_ms.read(gctx) == pytest.approx(2e-3)
    least = 3 * counts.least_seconds(*counts.coo_spmv(14, 50), peak)
    assert spmv_roofline.read(gctx) == pytest.approx(100 * least / 30e-6)
    assert pass_one_ms.read(gctx) is None
    nopeak = _Ctx(fused, {"method": "two_pass"}, [7], None)
    assert pass_one_roofline.read(nopeak) is None


def test_generic_solve_ms_is_the_mean_of_the_calls_before_the_stretch():
    from h100_bench.metrics import generic_solve_ms
    ctx = types.SimpleNamespace(call_ms=[200.0, 300.0, 250.0])
    assert generic_solve_ms.read(ctx) == pytest.approx(250.0)
    assert generic_solve_ms.read(types.SimpleNamespace(call_ms=[])) is None


@pytest.mark.parametrize("name", ["launches_per_solve", "f_tk_ms"])
def test_a_split_metric_reads_as_its_original(name):
    from h100_bench import harness
    split = harness.module("metrics", f"{name}.sparse")
    assert split.read is harness.module("metrics", name).read


def test_judge_takes_the_worst_and_counts_failed_solves():
    from h100_bench import compare
    ok, failed, checks = compare.judge(
        [{"a": 1.0, "b": 0.0}, {"a": 3.0, "b": float("nan")}],
        {"a": 2.0, "b": 0.0})
    assert (ok, failed) == (False, 1)
    assert checks["a"] == {"value": 3.0, "limit": 2.0}
    assert np.isnan(checks["b"]["value"])
    assert compare.judge([], {"a": 1.0})[0] is False
    with pytest.raises(KeyError):
        compare.judge([{"a": 1.0}], {"a": 1.0, "c": 1.0})


def _decomposition(k, seed):
    rng = np.random.default_rng(seed)
    alphas = rng.uniform(1e5, 3e5, k)
    betas = np.r_[rng.uniform(1e5, 2e5, k - 1), 0.0]
    x = rng.standard_normal(30)
    return kkt.Result(x=x, alphas=alphas, betas=betas, b_norm=5.0, steps=k)


def _got(res, **change):
    got = {"x": res.x.copy(), "alphas": res.alphas.copy(),
           "betas": res.betas.copy(), "steps": np.float64(res.steps),
           "b_norm": np.float64(res.b_norm)}
    got.update(change)
    return got


def test_ritz_ends_are_the_tridiagonals_extreme_eigenvalues():
    from h100_bench import compare
    res = _decomposition(40, 3)
    t = (np.diag(res.alphas[:25]) + np.diag(res.betas[:24], 1)
         + np.diag(res.betas[:24], -1))
    theta = np.linalg.eigvalsh(t)
    assert compare.ritz_ends(res.alphas, res.betas, 25) == pytest.approx(
        (theta[0], theta[-1]))


ALL = ("x_gap", "bnorm_gap", "steps_gap", "ritz_gap", "ab_gap")


@pytest.mark.parametrize("change,moved,still", [
    ({}, (), ALL),
    ({"b_norm": np.float64(5.0 * (1 + 1e-6))}, ("bnorm_gap",),
     ("x_gap", "steps_gap", "ritz_gap", "ab_gap")),
    ({"late_alpha": 1 + 1e-3}, ("ritz_gap",),
     ("x_gap", "bnorm_gap", "steps_gap", "ab_gap")),
    ({"early_alpha": 1 + 1e-3}, ("ab_gap",),
     ("x_gap", "bnorm_gap", "steps_gap")),
    ({"x": 1.3}, ("x_gap",), ("bnorm_gap", "steps_gap", "ritz_gap",
                              "ab_gap"))])
def test_each_number_sees_its_own_fault(change, moved, still):
    """A wrong ‖b‖ moves ``bnorm_gap`` alone; α spoiled past the steps
    ``ab_gap`` reads moves ``ritz_gap`` alone."""
    from h100_bench import compare
    res = _decomposition(200, 5)
    got = _got(res)
    if "late_alpha" in change:
        got["alphas"][compare.AB_STEPS + 10:] *= change.pop("late_alpha")
    if "early_alpha" in change:
        got["alphas"][3] *= change.pop("early_alpha")
    if "x" in change:
        got["x"] = got["x"] * change.pop("x")
    got.update(change)
    nums = compare.numbers(got, res)
    assert set(nums) == set(ALL)
    for name in moved:
        assert nums[name] > 1e-7, name
    for name in still:
        assert nums[name] < 1e-12, name
