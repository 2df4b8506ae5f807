"""The arc-sharded solver's fused step (``parallel/sharded_step.py``) driven
on the CPU through the plain version of its kernels.

The kernels of the step (K7's step instances in ``csrc/kkt_shard_matvec.cu``
and ``csrc/shard_step.cu``) run only on a card, where
``tests/test_torch_cuda.py`` holds them to the core scans and to one card's
solver, and ``chip_smoke.py`` each to its plain version. Here
``sharded_step.PlainStepKernels`` does what each kernel does, in PyTorch,
on the tensors themselves, and the solver runs one rank with the fold an
identity: what this checks is the host side of the step, the buffers each
launch names (the three rotating vectors, the two state slots), the masks
of a breakdown, a zero b and the step limit, the chunked and the basis
passes, pass two's state, and the counters. The plain kernels sum their
dots in their own order, so the core scans are met within float32
rounding; the fused paths among themselves bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_cases import CPU, breakdown_kkt, random_kkt
from two_pass_lanczos_tpu_torch.algorithms.core import (
    pass_one_last_vector,
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    kkt_shard_matvec,
    scaled_y,
)
from two_pass_lanczos_tpu_torch.parallel import fused_sharded, sharded_step
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh


class _OneRank(fused_sharded.ShardedFusedKKTSolver):
    """The solver on one CPU rank, taking the card's passes on the plain
    kernels."""

    _cuda = True

    def __init__(self, *args):
        super().__init__(*args)
        self._passes.kernels = sharded_step.PlainStepKernels()


@pytest.fixture
def fused(monkeypatch):
    """A solver factory whose card paths run the plain kernels on one rank
    (every fold the identity)."""
    monkeypatch.setattr(sharded_step, "all_gather",
                        lambda t, mesh: t.reshape((1,) + t.shape).clone())
    monkeypatch.setattr(fused_sharded, "gather_fold", lambda t, mesh: t)
    mesh = Mesh(group=None, rank=0, size=1, device=CPU)

    def make(d, u, v, p):
        return _OneRank(d, u, v, p, mesh)

    return make


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    d, u, v, p = random_kkt(rng, m=600, p=200)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, torch.from_numpy(b)


def _plain_mv(s):
    return lambda x: kkt_shard_matvec(s.layout, x)


def test_fused_pass_one_meets_the_core_scan(fused):
    d, u, v, p, b = _problem()
    s = fused(d, u, v, p)
    k = 30
    state = torch.empty(2, s.n_local)
    dec = s.pass_one(b, k, state=state)
    ref_state = torch.empty(2, s.n_local)
    ref, _ = pass_one_scan(_plain_mv(s), b, k, state=ref_state)
    assert dec.steps() == ref.steps() == k
    np.testing.assert_allclose(dec.alphas.numpy(), ref.alphas.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(dec.betas.numpy(), ref.betas.numpy(),
                               rtol=1e-4)
    assert float(dec.b_norm) == pytest.approx(float(ref.b_norm), rel=1e-6)
    assert torch.allclose(state, ref_state, atol=1e-4)


def test_fused_chunks_are_the_monolithic_pass_bitwise(fused):
    d, u, v, p, b = _problem(1)
    s = fused(d, u, v, p)
    k = 23
    whole = s.pass_one(b, k)
    for chunk in (1, 5, 7, 23, 40):
        dec, stopped = s.pass_one_chunked(b, k, chunk=chunk)
        assert not stopped and dec.steps() == k
        assert torch.equal(dec.alphas, whole.alphas)
        assert torch.equal(dec.betas, whole.betas)
        assert torch.equal(dec.b_norm, whole.b_norm)


def test_fused_pass_two_replays_the_basis_bitwise(fused):
    d, u, v, p, b = _problem(2)
    s = fused(d, u, v, p)
    k = 15
    dec, basis = s.pass_one_with_basis(b, k)
    assert torch.equal(dec.alphas, s.pass_one(b, k).alphas)
    # y = I: row i of x is v_{i+1} as pass two regenerates it
    rows = s.pass_two(b, dec, torch.eye(k))
    assert torch.equal(rows, basis)
    x = s.pass_two(b, dec, scaled_y(dec, "inv", k))
    ref = pass_two_scan(_plain_mv(s), b, dec, scaled_y(dec, "inv", k))[0]
    assert torch.allclose(x, ref, rtol=1e-5, atol=1e-6)


def test_fused_breakdown_masks_the_state(fused):
    d, u, v, p, b = breakdown_kkt()
    s = fused(d, u, v, p)
    b = torch.from_numpy(b)
    k = 12
    st1, st2 = torch.empty(2, s.n_local), torch.empty(2, s.n_local)
    dec = s.pass_one(b, k, state=st1)
    ref_state = torch.empty(2, s.n_local)
    ref, _ = pass_one_scan(_plain_mv(s), b, k, state=ref_state)
    steps = dec.steps()
    assert steps == ref.steps() < k
    assert float(dec.betas[steps - 1]) == 0.0 and not dec.alphas[steps:].any()
    np.testing.assert_allclose(dec.alphas.numpy(), ref.alphas.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.allclose(st1, ref_state, atol=1e-5)
    dec_b, basis = s.pass_one_with_basis(b, k)
    assert not basis[steps:].any()
    y = scaled_y(dec, "inv", k)
    x = s.pass_two(b, dec, y, state=st2)
    # the final state is pass one's v_{steps}; x stops changing past it
    assert torch.equal(st2[1], pass_one_last_vector(dec, st1))
    assert torch.equal(s.pass_two(b, dec, torch.eye(k)), basis)
    ref_x = pass_two_scan(_plain_mv(s), b, dec, y)[0]
    assert torch.allclose(x, ref_x, rtol=1e-5, atol=1e-6)
    # a chunk boundary inside the dead steps changes nothing
    dec_c, _ = s.pass_one_chunked(b, k, chunk=3)
    assert torch.equal(dec_c.alphas, dec.alphas)


def test_fused_zero_b_takes_no_step(fused):
    d, u, v, p, _ = _problem(3)
    s = fused(d, u, v, p)
    zero = torch.zeros(s.n)
    dec = s.pass_one(zero, 8)
    assert dec.steps() == 0 and not dec.alphas.any() and not dec.betas.any()
    x = s.pass_two(zero, dec, scaled_y(dec, "inv", 8))
    assert not x.any()


def test_fused_solve_of_two_functions_is_each_ones(fused):
    d, u, v, p, b = _problem(4)
    s = fused(d, u, v, p)
    k = 12
    x2, dec = s._eager_solve(b, k, ("inv", "exp"), "two_pass", None, 16)
    x_inv, _ = s._eager_solve(b, k, "inv", "two_pass", None, 16)
    assert x2.shape == (2, s.n_local)
    assert torch.equal(x2[0], x_inv)
    y = scaled_y(dec, ("inv", "exp"), k)
    ref = pass_two_scan(_plain_mv(s), b, dec, y)[0]
    assert torch.allclose(x2, ref, rtol=1e-5, atol=1e-6)


def test_fused_step_counts_its_launches(fused):
    d, u, v, p, b = _problem(5)
    s = fused(d, u, v, p)
    k = 9
    before = dict(sharded_step.STEP_KERNELS), LAUNCHES["kkt_streaming_matvec"]
    s._eager_solve(b, k, "inv", "two_pass", None, 16)
    added = {name: sharded_step.STEP_KERNELS[name] - before[0][name]
             for name in before[0]}
    assert added == {"shard_step_node_fold": k, "shard_step_orthogonalise": k,
                     "shard_step_norm": k, "shard_step_advance": k,
                     "shard_step_two_nodes": k - 1}
    assert LAUNCHES["kkt_streaming_matvec"] - before[1] == 2 * k - 1
    assert fused_sharded.STEP_KERNELS is sharded_step.STEP_KERNELS


def test_card_kernels_pass_pointers_in_the_entry_points_order(monkeypatch):
    """``CudaStepKernels`` hands a layout as its seven arguments, a tensor
    as its pointer, ``None`` as a null pointer and numbers as they are,
    then the stream, and raises on a failed launch."""
    calls = []

    class Lib:
        def tpl_shard_step_advance(self, *args):
            calls.append(args)
            return len(calls) - 1  # the second launch fails

        def tpl_error_string(self, code):
            return b"failed"

    monkeypatch.setattr(sharded_step, "load_library", Lib)
    monkeypatch.setattr(sharded_step, "_stream", lambda: "stream")
    d, u, v, p, _ = _problem(6)
    s = fused_sharded.ShardedFusedKKTSolver(
        d, u, v, p, Mesh(group=None, rank=0, size=1, device=CPU))
    lay, w = s.layout, torch.zeros(s.n_local)
    kernels = sharded_step.CudaStepKernels()
    kernels("advance", lay, None, 3, 0.5, w)
    got = calls[0]
    assert len(got) == 7 + 4 + 1 and got[-1] == "stream"
    assert [a.value for a in got[:5]] == [
        t.data_ptr() for t in (lay.d, lay.u, lay.v, lay.ptr, lay.ent)]
    assert got[5:7] == (lay.m, lay.p)
    assert got[7].value is None and got[8:10] == (3, 0.5)
    assert got[10].value == w.data_ptr()
    with pytest.raises(RuntimeError, match="shard_step_advance"):
        kernels("advance", lay, None, 3, 0.5, w)
