"""The port's operators (``operators.py``, ``ops/spmv.py``) and K8's module
(``ops/spmv_kernel.py``) against the JAX package on the CPU.

K8's JAX side is the Pallas kernel itself, ``PallasKKTOperator`` run in the
Pallas interpreter as ``tests/test_loaders.py`` runs it; the port's side is
its plain version, which the wrapper takes for a CPU tensor. Both get the
same seeded NumPy inputs. Tolerances: rel 1e-6 for the f32 KKT matvec (the
JAX test's own: the bf16×3 split is exact and only the order of the node
sums differs), 1e-14 relative for f64 conversions, 1e-6 for f32 ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import CASES, CPU
from two_pass_lanczos_tpu import operators as jops
from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo as jax_sorted_coo
from two_pass_lanczos_tpu.ops.spmv import coo_spmv as jax_coo_spmv
from two_pass_lanczos_tpu.ops.spmv import csr_from_triplets as jax_csr
from two_pass_lanczos_tpu.utils.data_loader import KKTArrays as JaxArrays
from two_pass_lanczos_tpu_torch import (
    CallableOperator,
    CudaKKTOperator,
    DenseOperator,
    DiagonalOperator,
    KKTOperator,
    SparseOperator,
    as_operator,
    make_kkt_operator,
)
from two_pass_lanczos_tpu_torch.convert import operator_from_jax
from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES
from two_pass_lanczos_tpu_torch.ops.spmv import (
    SortedCOO,
    coo_spmv,
    csr_from_triplets,
    kkt_matvec,
)
from two_pass_lanczos_tpu_torch.ops.spmv_kernel import (
    kkt_operator_matvec,
    kkt_operator_matvec_cuda,
)


def _rel_max(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _loaders_case(rng):
    # the instance of tests/test_loaders.py::test_pallas_kkt_kernel_interpret_mode
    m, p = 300, 40
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1, 3, m).astype(np.float32)
    return d, u, v, p


K8_CASES = dict(CASES, loaders=_loaders_case)


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_k8_plain_version_matches_pallas_interpret(case):
    rng = np.random.default_rng(5)
    d, u, v, p = K8_CASES[case](rng)
    x = rng.standard_normal(len(d) + p).astype(np.float32)
    pal = jops.PallasKKTOperator.build(d, u, v, p, interpret=True)
    y_pal = np.asarray(pal.matvec(jnp.asarray(x)))
    op = make_kkt_operator(d, u, v, p, device=CPU)
    before = LAUNCHES["kkt_operator_matvec"]
    y = op.matvec(torch.from_numpy(x)).numpy()
    assert LAUNCHES["kkt_operator_matvec"] == before  # no kernel on the CPU
    assert y.dtype == np.float32
    assert _rel_max(y, y_pal) < 1e-6
    # the port's Pallas counterpart, built from the JAX operator's arrays
    ported = operator_from_jax(pal, device=CPU)
    assert isinstance(ported, CudaKKTOperator)
    assert ported.shape == pal.shape and ported.dtype == torch.float32
    np.testing.assert_array_equal(ported.matvec(torch.from_numpy(x)).numpy(), y)


def test_k8_wrapper_takes_only_what_the_kernel_takes():
    rng = np.random.default_rng(0)
    d, u, v, p = CASES["random"](rng)
    op = make_kkt_operator(d, u, v, p, device=CPU)
    x = torch.from_numpy(rng.standard_normal(len(d) + p).astype(np.float32))
    t = torch.from_numpy
    np.testing.assert_array_equal(kkt_operator_matvec(op.layout, x).numpy(),
                                  kkt_matvec(t(d), t(u), t(v), p, x).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        kkt_operator_matvec_cuda(op.layout, x)  # a CPU layout: no kernel
    op16 = make_kkt_operator(d, u, v, p, dtype=torch.float16,
                             backend="plain", device=CPU)
    with pytest.raises(ValueError, match="f32 and f64"):
        kkt_operator_matvec_cuda(op16.layout, x.half())


def test_make_kkt_operator_backends_on_cpu():
    rng = np.random.default_rng(1)
    d, u, v, p = CASES["hub"](rng)
    auto = make_kkt_operator(d.astype(np.float64), u, v, p, device=CPU)
    assert type(auto) is KKTOperator and auto.dtype == torch.float64
    assert auto.num_arcs == len(d) and auto.num_nodes == p
    assert auto.nnz == 5 * len(d)
    x = torch.from_numpy(rng.standard_normal(len(d) + p))
    # the backend is checked and chooses nothing: the dtype comes from d
    # (f32 here) and the device decides the matvec
    y32 = make_kkt_operator(d, u, v, p, device=CPU).matvec(x.float())
    for backend in ("plain", "cuda"):
        op = make_kkt_operator(d, u, v, p, backend=backend, device=CPU)
        assert type(op) is CudaKKTOperator is KKTOperator
        assert op.dtype == torch.float32
        assert torch.equal(op.matvec(x.float()), y32)
    np.testing.assert_allclose(
        y32.numpy(), auto.matvec(x).numpy(),
        rtol=0, atol=1e-5 * float(auto.matvec(x).abs().max()))
    with pytest.raises(ValueError, match="backend"):
        make_kkt_operator(d, u, v, p, backend="xla", device=CPU)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_and_diagonal_from_jax(dtype):
    rng = np.random.default_rng(2)
    n = 50
    a = rng.standard_normal((n, n)).astype(dtype)
    a = a + a.T
    diag = rng.uniform(1, 3, n).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    tol = 1e-14 if dtype == np.float64 else 1e-6
    for jop in (jops.DenseOperator(jnp.asarray(a)),
                jops.DiagonalOperator(jnp.asarray(diag))):
        op = operator_from_jax(jop, device=CPU)
        assert type(op).__name__ == type(jop).__name__
        assert op.shape == jop.shape
        y = op.matvec(torch.from_numpy(x)).numpy()
        assert y.dtype == dtype
        assert _rel_max(y, np.asarray(jop.matvec(jnp.asarray(x)))) < tol


def _jax_arrays(rng):
    d, u, v, p = CASES["random"](rng)
    return JaxArrays(quad_costs=d.astype(np.float64), arc_u=u, arc_v=v,
                     num_nodes=p, num_arcs=len(d))


def test_sparse_and_kkt_from_jax_f64():
    rng = np.random.default_rng(3)
    arrays = _jax_arrays(rng)
    n = arrays.n
    x = rng.standard_normal(n)
    jsp = jops.SparseOperator(jax_sorted_coo(arrays))
    jkkt = jops.KKTOperator(d=jnp.asarray(arrays.quad_costs),
                            arc_u=jnp.asarray(arrays.arc_u),
                            arc_v=jnp.asarray(arrays.arc_v),
                            num_nodes=arrays.num_nodes)
    for jop, cls in ((jsp, SparseOperator), (jkkt, KKTOperator)):
        op = operator_from_jax(jop, device=CPU)
        assert type(op) is cls and op.shape == (n, n)
        assert op.dtype == torch.float64
        y = op.matvec(torch.from_numpy(x)).numpy()
        assert _rel_max(y, np.asarray(jop.matvec(jnp.asarray(x)))) < 1e-14
    assert operator_from_jax(jsp, device=CPU).mat.nnz == jsp.mat.nnz
    with pytest.raises(TypeError, match="CallableOperator"):
        operator_from_jax(jops.CallableOperator(fn=lambda z: z, n=3),
                          device=CPU)


def test_csr_from_triplets_matches_jax():
    rng = np.random.default_rng(4)
    n_rows, n_cols, nnz = 30, 25, 200  # with duplicates
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    ours = csr_from_triplets(n_rows, n_cols, rows, cols, vals, device=CPU)
    ref = jax_csr(n_rows, n_cols, rows, cols, vals)
    assert ours.nnz == ref.nnz and ours.shape == ref.shape
    np.testing.assert_allclose(ours.todense().numpy(),
                               np.asarray(ref.todense()), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(ours.rows.numpy(),
                                  np.asarray(ref.rows)[:ref.nnz])
    np.testing.assert_array_equal(ours.cols.numpy(),
                                  np.asarray(ref.cols)[:ref.nnz])
    assert ours.indptr[-1] == ours.nnz
    x = rng.standard_normal(n_cols)
    y = coo_spmv(ours, torch.from_numpy(x)).numpy()
    y_ref = np.asarray(jax_coo_spmv(ref, jnp.asarray(x)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-14, atol=1e-14)
    # an empty row sums to 0, and the product is the same every time
    assert torch.equal(coo_spmv(ours, torch.from_numpy(x)),
                       coo_spmv(ours, torch.from_numpy(x)))
    with pytest.raises(ValueError, match="row index"):
        csr_from_triplets(2, 2, [2], [0], [1.0], device=CPU)
    with pytest.raises(ValueError, match="col index"):
        csr_from_triplets(2, 2, [0], [-1], [1.0], device=CPU)


def test_as_operator_and_callable():
    a = np.array([[2.0, 1.0], [1.0, 3.0]])
    assert isinstance(as_operator(a, device=CPU), DenseOperator)
    assert isinstance(as_operator(np.ones(3), device=CPU), DiagonalOperator)
    coo = csr_from_triplets(2, 2, [0, 1], [0, 1], [1.0, 2.0], device=CPU)
    assert isinstance(coo, SortedCOO)
    assert isinstance(as_operator(coo, device=CPU), SparseOperator)
    op = DiagonalOperator(np.ones(2), device=CPU)
    assert as_operator(op) is op
    with pytest.raises(TypeError):
        as_operator(np.ones((2, 2, 2)), device=CPU)
    call = CallableOperator(lambda z: 2 * z, 4, device=CPU)
    assert call.shape == (4, 4) and call.dtype == torch.float64
    np.testing.assert_array_equal(call(torch.ones(4)).numpy(), 2.0)


def test_complex_dense_operator():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6))
    a = (m + m.conj().T) / 2
    x = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    op = DenseOperator(a, device=CPU)
    assert op.dtype == torch.complex128
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(), a @ x,
                               rtol=1e-14)
