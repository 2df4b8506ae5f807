"""The port's single recurrence step and norm (``algorithms/core.py``) held
against the JAX package's, on ``tests/test_core.py``'s inputs in f64 and at
its tolerance (1e-15): the reference's inline unit tests
(``src/algorithms/mod.rs:384-428``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu.algorithms.core import (
    l2_norm as jax_l2_norm,
    lanczos_recurrence_step as jax_step,
)
from two_pass_lanczos_tpu_torch.algorithms import lanczos_recurrence_step
from two_pass_lanczos_tpu_torch.algorithms.core import l2_norm, pass_one_scan

#: tridiag(1, 2, 1), 4 x 4: the known matrix of ``test_core.py``
A4 = np.array([[2.0, 1, 0, 0], [1, 2, 1, 0], [0, 1, 2, 1], [0, 0, 1, 2]])
E = np.eye(4)


@pytest.mark.parametrize("v,v_prev,beta_prev,alpha,beta,w", [
    # w = A e1 = [2,1,0,0]; alpha = 2; w - alpha e1 = e2; beta = 1
    (E[0], np.zeros(4), 0.0, 2.0, 1.0, E[1]),
    # the second step of that run: A e2 - 1 e1 = [0,2,1,0]; alpha = 2
    (E[1], E[0], 1.0, 2.0, 1.0, E[2]),
    # from e2: A e2 = [1,2,1,0]; alpha = 2; w = [1,0,1,0]; beta = sqrt 2
    (E[1], np.zeros(4), 0.0, 2.0, math.sqrt(2.0), E[0] + E[2]),
], ids=["e1", "e2-after-e1", "e2"])
def test_single_recurrence_step_known_values(v, v_prev, beta_prev, alpha,
                                             beta, w):
    ja = jnp.asarray(A4)
    ref = jax_step(lambda x: ja @ x, jnp.asarray(v), jnp.asarray(v_prev),
                   jnp.asarray(beta_prev, jnp.float64))
    ta = torch.from_numpy(A4)
    got = lanczos_recurrence_step(
        lambda x: ta @ x, torch.from_numpy(v), torch.from_numpy(v_prev),
        torch.tensor(beta_prev, dtype=torch.float64))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-15)
    assert float(got[0]) == pytest.approx(alpha, abs=1e-15)
    assert float(got[1]) == pytest.approx(beta, abs=1e-15)
    np.testing.assert_allclose(got[2].numpy(), w, atol=1e-15)


@pytest.mark.parametrize("x,norm", [
    (np.array([3 + 4j, 0.0], np.complex128), 5.0),
    (np.array([3.0, 0.0, 4.0], np.float64), 5.0),
], ids=["complex128", "float64"])
def test_l2_norm(x, norm):
    got = l2_norm(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(norm, rel=1e-15)
    assert float(got) == pytest.approx(float(jax_l2_norm(jnp.asarray(x))),
                                       rel=1e-15)


def test_pass_one_runs_the_public_step():
    # the masked pass one is lanczos_recurrence_step and the normalisation,
    # bit for bit: one recurrence, not two
    rng = np.random.default_rng(3)
    m = rng.standard_normal((30, 30))
    a = torch.from_numpy((m + m.T) / 2)
    b = torch.from_numpy(rng.standard_normal(30))
    dec, _ = pass_one_scan(lambda x: a @ x, b, 4)
    v = b * (1.0 / l2_norm(b))
    v_prev, beta_prev = torch.zeros_like(b), torch.zeros((), dtype=b.dtype)
    for j in range(4):
        alpha, beta, w = lanczos_recurrence_step(lambda x: a @ x, v, v_prev,
                                                 beta_prev)
        assert torch.equal(dec.alphas[j], alpha)
        assert torch.equal(dec.betas[j], beta)
        v_prev, v, beta_prev = v, w * (1.0 / beta), beta
    assert torch.equal(dec.b_norm, l2_norm(b))
