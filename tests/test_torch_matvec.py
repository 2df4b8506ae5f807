"""KKT matvec of the port (``ops/spmv.kkt_matvec``, the layout of
``ops/kkt_fused.KKTLayout``) held against the JAX package's XLA
``kkt_matvec`` and fused interpret-mode matvec, at ``tests/test_fused.py``'s
tolerance (2e-5·max|y| in f32) and 1e-12 in f64. The CUDA kernel
``csrc/kkt_matvec.cu`` is held to the plain version in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import CASES, CPU
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu.ops.spmv import kkt_matvec as jax_kkt_matvec
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver, KKTLayout
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


def _problem(case, seed, dtype):
    rng = np.random.default_rng(seed)
    d, u, v, p = CASES[case](rng)
    x = rng.standard_normal(len(d) + p)
    return d.astype(dtype), u, v, p, x.astype(dtype)


def _plain(d, u, v, p, x):
    t = torch.from_numpy
    return kkt_matvec(t(d), t(u), t(v), p, t(x)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_f32(case):
    d, u, v, p, x = _problem(case, 1, np.float32)
    y_ref = np.asarray(jax_kkt_matvec(jnp.asarray(d), jnp.asarray(u),
                                      jnp.asarray(v), p, jnp.asarray(x)))
    y = _plain(d, u, v, p, x)
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_f64(case):
    d, u, v, p, x = _problem(case, 2, np.float64)
    y_ref = np.asarray(jax_kkt_matvec(jnp.asarray(d), jnp.asarray(u),
                                      jnp.asarray(v), p, jnp.asarray(x)))
    np.testing.assert_allclose(_plain(d, u, v, p, x), y_ref, rtol=0,
                               atol=1e-12 * np.abs(y_ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matvec_matches_fused_interpret(case):
    d, u, v, p, x = _problem(case, 3, np.float32)
    y_ref = JaxFused(d, u, v, p, interpret=True).matvec(x)
    y = FusedKKTSolver(d, u, v, p, device=CPU).matvec(x).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_csr_is_the_incidence(case):
    # the node part of the CUDA kernel reads ptr/ent: entry a is +x_a[a],
    # entry ~a is -x_a[a]; summed per node this must be E·x_a, in f64 exactly
    d, u, v, p, x = _problem(case, 4, np.float64)
    lay = KKTLayout.build(d, u, v, p, "cpu")
    ptr, ent = lay.ptr.numpy(), lay.ent.numpy()
    assert ptr[0] == 0 and ptr[-1] == 2 * len(d) and np.all(np.diff(ptr) >= 0)
    m = len(d)
    signed = np.where(ent >= 0, x[:m][np.where(ent >= 0, ent, 0)],
                      -x[:m][np.where(ent < 0, ~ent, 0)])
    y_n = np.array([signed[ptr[i]:ptr[i + 1]].sum() for i in range(p)])
    np.testing.assert_allclose(y_n, _plain(d, u, v, p, x)[m:], rtol=0,
                               atol=1e-12 * np.abs(x).sum())
    # every arc appears once with each sign, at its endpoints' segments
    node_of = np.repeat(np.arange(p), np.diff(ptr))
    np.testing.assert_array_equal(np.sort(ent[ent >= 0]), np.arange(m))
    np.testing.assert_array_equal(node_of[ent >= 0][np.argsort(ent[ent >= 0])], u)
    np.testing.assert_array_equal(np.sort(~ent[ent < 0]), np.arange(m))
    np.testing.assert_array_equal(node_of[ent < 0][np.argsort(~ent[ent < 0])], v)
