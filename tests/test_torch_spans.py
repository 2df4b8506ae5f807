"""The port's spans (``observability.trace``) on the solve paths, read from a
CPU ``torch.profiler`` trace: their names, their nesting in ``tpl.solve``,
one ``tpl.spmv`` a generic product, and no ``record_function`` at all while
no profiler records."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu_torch import (
    FusedKKTSolver,
    SparseOperator,
    observability,
    solve_fAb,
)
from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

K = 12


def _instance():
    return random_kkt(np.random.default_rng(5), m=120, p=40)


def _fused():
    return FusedKKTSolver(*_instance(), device=CPU)


def _sparse():
    d, u, v, p = _instance()
    arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                       num_arcs=d.shape[0])
    return SparseOperator(kkt_sorted_coo(arrays, dtype=np.float32,
                                         device=CPU), device=CPU)


def _b(n):
    return torch.from_numpy(
        np.random.default_rng(6).standard_normal(n).astype(np.float32))


def _spans(fn):
    """``[(name, parent)]`` of the ``tpl.*`` spans ``fn`` opens under the
    profiler, in the order they start; the parent is the nearest enclosing
    ``tpl.*`` span (None for none)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not ev.name.startswith("tpl."):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith("tpl."):
            up = up.cpu_parent
        out.append((ev.name, None if up is None else up.name))
    return out


@pytest.mark.parametrize("method, last, kwargs", [
    ("two_pass", "tpl.pass_two", {}),
    ("one_pass", "tpl.basis_product", {}),
    ("two_pass", "tpl.pass_two", {"callback": lambda *_: True,
                                  "callback_chunk": 5}),
    ("two_pass", "tpl.pass_two", {"f": ("inv", "exp")}),
])
def test_fused_solve_spans_nest_in_the_solve(method, last, kwargs):
    s = _fused()
    got = _spans(lambda: s.solve(_b(s.n), k=K, method=method, **kwargs))
    assert got == [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
                   ("tpl.f_tk", "tpl.solve"), (last, "tpl.solve")]


@pytest.mark.parametrize("method, last", [("two_pass", "tpl.pass_two"),
                                          ("one_pass", "tpl.basis_product")])
def test_generic_solve_spans_nest_in_the_solve(method, last):
    op = _sparse()
    products = []
    matvec = op.matvec

    def counted(x):
        products.append(1)
        return matvec(x)

    op.matvec = counted
    got = _spans(lambda: solve_fAb(op, _b(op.shape[0]), k=K, f="inv",
                                   method=method))
    phases = [(name, parent) for name, parent in got if name != "tpl.spmv"]
    assert phases == [("tpl.solve", None), ("tpl.pass_one", "tpl.solve"),
                      ("tpl.f_tk", "tpl.solve"), (last, "tpl.solve")]
    spmv = [parent for name, parent in got if name == "tpl.spmv"]
    assert len(spmv) == len(products) > 0
    # the products of each pass, in the pass's span
    inside = {"tpl.pass_one"} if method == "one_pass" else {
        "tpl.pass_one", "tpl.pass_two"}
    assert set(spmv) == inside
    if method == "two_pass":
        assert spmv.count("tpl.pass_two") == spmv.count("tpl.pass_one") - 1


def test_a_two_pass_generic_solve_opens_a_span_per_product():
    op = _sparse()
    got = _spans(lambda: solve_fAb(op, _b(op.shape[0]), k=K, f="inv"))
    # pass one's K products and pass two's K - 1 (no breakdown at K = 12)
    assert [name for name, _ in got].count("tpl.spmv") == 2 * K - 1


def test_no_span_enters_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    s, op = _fused(), _sparse()
    for method in ("two_pass", "one_pass"):
        s.solve(_b(s.n), k=K, method=method)
        solve_fAb(op, _b(op.shape[0]), k=K, f="inv", method=method)
    # one shared context, whatever the name
    assert observability.trace("tpl.a") is observability.trace("tpl.b")
