"""The port's four-property harness (``testing.py``) at the reference's
tolerances (k = 30, 5e-9, ``src/algorithms/mod.rs:360``), on the CPU in
f64, on the instances of ``tests/test_properties.py`` and
``tests/test_refgen_properties.py``: the generated size classes, the
vendored ``data/{1000,2000,3000}`` pairs and the reference toolchain's
``data/refgen`` snapshot. The exact replay makes the reconstruction drift
exactly 0, as in the JAX package. The instances come from the port's own
generator and loader, which give the JAX package's arrays bit for bit
(``tests/test_torch_package.py``, ``tests/test_torch_loaders.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU
from two_pass_lanczos_tpu import testing as jax_testing
from two_pass_lanczos_tpu.models.kkt import (
    kkt_operator_from_arrays as jax_from_arrays,
)
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays as JaxArrays
from two_pass_lanczos_tpu_torch import DenseOperator, DiagonalOperator
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.models.kkt import (
    kkt_operator_from_arrays,
    kkt_operator_from_files,
    kkt_sorted_coo,
)
from two_pass_lanczos_tpu_torch.operators import SparseOperator
from two_pass_lanczos_tpu_torch.testing import (
    DEFAULT_K,
    DEFAULT_TOL,
    check_decomposition_consistency,
    check_lanczos_relation,
    check_orthonormality,
    check_reconstruction_stability,
    run_all_properties,
    seeded_b,
)
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

REPO = Path(__file__).resolve().parents[1]
PROPERTIES = [
    check_decomposition_consistency,
    check_lanczos_relation,
    check_orthonormality,
    check_reconstruction_stability,
]


def _generated():
    """The three size classes of tests/test_properties.py:50-65."""
    out = {}
    for arcs, rho, iid in [(950, 3, 1), (1900, 3, 1), (2880, 2, 1)]:
        inst = generate_mcf_instance(arcs, rho=rho, instance_id=iid)
        out[f"gen-{arcs}-{rho}-{iid}"] = KKTArrays(
            quad_costs=inst.quad_costs, arc_u=inst.arc_u, arc_v=inst.arc_v,
            num_nodes=inst.num_nodes, num_arcs=inst.num_arcs)
    return out


GENERATED = _generated()
VENDORED = sorted(
    dmx.relative_to(REPO / "data").with_suffix("").as_posix()
    for size in ("1000", "2000", "3000", "refgen")
    for dmx in (REPO / "data" / size).glob("*.dmx"))


@pytest.fixture(scope="module", params=sorted(GENERATED))
def kkt_problem(request):
    sys = kkt_operator_from_arrays(GENERATED[request.param], device=CPU)
    return sys.operator, seeded_b(sys.n, device=CPU)


@pytest.mark.parametrize("prop", PROPERTIES, ids=lambda p: p.__name__)
def test_property_on_generated_instance(kkt_problem, prop):
    op, b = kkt_problem
    report = prop(op, b, DEFAULT_K, DEFAULT_TOL)
    assert report.passed, f"{report.name} = {report.value:.3e}"


def test_reconstruction_drift_exactly_zero(kkt_problem):
    op, b = kkt_problem
    assert check_reconstruction_stability(op, b).value == 0.0


def test_lanczos_relation_at_k_plus_one(kkt_problem):
    op, b = kkt_problem
    assert check_lanczos_relation(op, b, DEFAULT_K + 1).passed


def test_vendored_data_present():
    assert len(VENDORED) == 21, VENDORED


@pytest.mark.parametrize("prop", PROPERTIES, ids=lambda p: p.__name__)
@pytest.mark.parametrize("name", VENDORED)
def test_property_on_vendored_instance(name, prop):
    dmx = REPO / "data" / f"{name}.dmx"
    sys = kkt_operator_from_files(dmx, dmx.with_suffix(".qfc"), device=CPU)
    report = prop(sys.operator, seeded_b(sys.n, device=CPU), DEFAULT_K,
                  DEFAULT_TOL)
    assert report.passed, f"{name}: {report.name} = {report.value:.3e}"
    if prop is check_reconstruction_stability:
        assert report.value == 0.0


def test_harness_matches_jax_on_generated_instance():
    arrays = GENERATED["gen-950-3-1"]
    sys = kkt_operator_from_arrays(arrays, device=CPU)
    jsys = jax_from_arrays(JaxArrays(*arrays))
    b = seeded_b(sys.n, device=CPU)
    jb = jax_testing.seeded_b(sys.n)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    for ours, ref in zip(run_all_properties(sys.operator, b),
                         jax_testing.run_all_properties(jsys.operator, jb)):
        assert ours.name == ref.name and ours.passed and ref.passed
    # the exactly-replayed drift is 0 in both packages
    assert ours.value == ref.value == 0.0


def test_harness_handles_early_breakdown():
    op = DiagonalOperator(np.arange(1.0, 6.0), device=CPU)  # n = 5 << k
    reports = run_all_properties(op)
    assert all(r.passed for r in reports), [str(r) for r in reports]


def test_harness_on_complex_hermitian_operator():
    # beyond the reference, whose generated tests are real only
    rng = np.random.default_rng(7)
    n = 200
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    op = DenseOperator((m + m.conj().T) / 2, device=CPU)
    b = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    reports = run_all_properties(op, b)
    assert all(r.passed for r in reports), [str(r) for r in reports]
    assert reports[-1].value == 0.0


def test_harness_on_sparse_operator():
    arrays = GENERATED["gen-950-3-1"]
    op = SparseOperator(kkt_sorted_coo(arrays, device=CPU), device=CPU)
    reports = run_all_properties(op, seeded_b(op.shape[0], device=CPU))
    assert all(r.passed for r in reports), [str(r) for r in reports]
    assert reports[-1].value == 0.0
    # the same A as the matrix-free operator
    kkt = kkt_operator_from_arrays(arrays, device=CPU).operator
    x = seeded_b(op.shape[0], seed=3, device=CPU)
    y, y_ref = op.matvec(x).numpy(), kkt.matvec(x).numpy()
    assert np.max(np.abs(y - y_ref)) <= 1e-12 * np.max(np.abs(y_ref))
