"""The node walk of the matvec (K1's node rows, also the matvec phase of the
persistent K2 and K3), checked without a card.

``kkt_node_row`` (``csrc/lanczos_common.cuh``) sums each node's signed arc
entries in one fixed order: 256 strided per-thread partials, then a fixed
pairwise tree. ``tests/torch_cases.node_rows_in_kernel_order`` emulates that
order in plain PyTorch; here it is held to the exact sum and to the JAX
package's interpret-mode fused matvec at ``tests/test_fused.py``'s tolerance
(2e-5·max|y|), and ``tests/test_torch_cuda.py`` holds K1 to it bit for bit.
``kkt_node_row_warp``, the warp row that K1, K8, K7 and the persistent
passes run, computes the same sum in one warp: 8 partials a lane, three
tree levels in registers and five by shuffle.
``tests/torch_cases.node_rows_in_warp_order`` does that lane by lane, and is
held here to the block order bit for bit, in f32 (with and without K2's
scale) and f64. The phase timer of the persistent passes is read by
``phase_split``.
"""

import numpy as np
import pytest
import torch

from tests.torch_cases import (
    NODE_ROW_THREADS,
    NODE_WALK_CASES,
    node_rows_in_kernel_order,
    node_rows_in_warp_order,
)
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    PHASES,
    TIMED_STEPS,
    KKTLayout,
    phase_split,
)

CASES = sorted(NODE_WALK_CASES)


def _instance(case, seed):
    rng = np.random.default_rng(seed)
    d, u, v, p = NODE_WALK_CASES[case](rng)
    return d, u, v, p, rng


def test_the_cases_cover_the_walks_edges():
    deg = {c: np.bincount(np.concatenate(NODE_WALK_CASES[c](
        np.random.default_rng(0))[1:3])) for c in CASES}
    assert deg["wide_hub"].max() > 4 * NODE_ROW_THREADS
    assert (deg["degree_zero"] == 0).any() or len(deg["degree_zero"]) < 40
    d, u, v, p = NODE_WALK_CASES["self_loop"](np.random.default_rng(0))
    assert (u == v).any()


@pytest.mark.parametrize("scaled", [False, True], ids=["K1", "K2_scaled"])
@pytest.mark.parametrize("case", CASES)
def test_walk_order_is_one_fixed_summation(case, scaled):
    # the emulated order is one fixed summation order: within the error of
    # any order of each node sum, and exactly the f64 sum where every term is
    # an integer; K2's node rows read x_a times 1/beta (ScaledLoad)
    d, u, v, p, rng = _instance(case, 4)
    lay = KKTLayout.build(d, u, v, p, "cpu")
    m = len(d)
    scale = np.float32(1.0) / np.float32(3.7) if scaled else None
    x_a = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
    got = node_rows_in_kernel_order(lay.ptr, lay.ent, x_a, scale)
    assert got.dtype == torch.float32 and got.shape == (p,)
    xa64 = (x_a * scale if scaled else x_a).double()
    exact = torch.zeros(p, dtype=torch.float64)
    exact.index_add_(0, lay.u.long(), xa64).index_add_(0, lay.v.long(), -xa64)
    absum = torch.zeros(p, dtype=torch.float64)
    absum.index_add_(0, lay.u.long(), xa64.abs())
    absum.index_add_(0, lay.v.long(), xa64.abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).double()
    eps = float(np.finfo(np.float32).eps)
    assert bool(((got.double() - exact).abs() <= deg * eps * absum).all())
    ints = torch.from_numpy(rng.integers(-50, 50, m).astype(np.float32))
    got_i = node_rows_in_kernel_order(lay.ptr, lay.ent, ints)
    exact_i = torch.zeros(p, dtype=torch.float64)
    exact_i.index_add_(0, lay.u.long(), ints.double())
    exact_i.index_add_(0, lay.v.long(), -ints.double())
    assert torch.equal(got_i.double(), exact_i)


#: the two emulated orders: the block row and the warp row
ORDERS = {"block": node_rows_in_kernel_order, "warp": node_rows_in_warp_order}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("case", CASES)
def test_walk_order_matches_jax_fused_matvec(case, order):
    d, u, v, p, rng = _instance(case, 5)
    m = len(d)
    x = rng.standard_normal(m + p).astype(np.float32)
    y_ref = np.asarray(JaxFused(d, u, v, p, interpret=True).matvec(x))
    lay = KKTLayout.build(d, u, v, p, "cpu")
    y_n = ORDERS[order](lay.ptr, lay.ent, torch.from_numpy(x[:m])).numpy()
    np.testing.assert_allclose(y_n, y_ref[m:], rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("dtype,scaled", [
    (torch.float32, False), (torch.float32, True), (torch.float64, False)],
    ids=["f32", "f32_K2_scaled", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_warp_order_is_bitwise_the_block_order(case, dtype, scaled):
    # kkt_node_row_warp adds the same pairs as kkt_node_row: the same 256
    # partials, and block_sum's tree with its first three levels in
    # registers and its last five by shuffle, so every row has the block
    # row's bits, whatever the degree (a hub past 4·256 entries, degree 0,
    # a loop's + and - in one segment)
    d, u, v, p, rng = _instance(case, 6)
    lay = KKTLayout.build(d, u, v, p, "cpu")
    m = len(d)
    x_a = torch.from_numpy(rng.standard_normal(m)).to(dtype)
    scale = (torch.tensor(1.0, dtype=dtype) / torch.tensor(3.7, dtype=dtype)
             if scaled else None)
    warp = node_rows_in_warp_order(lay.ptr, lay.ent, x_a, scale)
    block = node_rows_in_kernel_order(lay.ptr, lay.ent, x_a, scale)
    assert warp.dtype == dtype and warp.shape == (p,)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(warp.view(bits), block.view(bits))
    # degree-0 rows are +0 in both, not -0
    deg = lay.ptr[1:] - lay.ptr[:-1]
    assert bool((warp[deg == 0].view(bits) == 0).all())


def test_warp_order_differs_from_a_plain_sequential_sum():
    # the emulation is a tree, not a running sum: on the hub a sequential
    # fold of the same terms rounds otherwise, so the bitwise check above
    # can fail
    d, u, v, p, rng = _instance("wide_hub", 6)
    lay = KKTLayout.build(d, u, v, p, "cpu")
    x_a = torch.from_numpy(rng.standard_normal(len(d)).astype(np.float32))
    warp = node_rows_in_warp_order(lay.ptr, lay.ent, x_a)
    ent = lay.ent.long()
    seq = torch.zeros(p)
    for i in range(p):
        acc = torch.zeros((), dtype=torch.float32)
        for a in ent[lay.ptr[i]:lay.ptr[i + 1]].tolist():
            acc = acc + x_a[a] if a >= 0 else acc - x_a[~a]
        seq[i] = acc
    assert not torch.equal(warp, seq)
    np.testing.assert_allclose(warp.numpy(), seq.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_phase_split_reads_the_stamps():
    # a clock as the kernels fill it: (steps, blocks, phases + 1) ns stamps
    name = "lanczos_pass_two"
    blocks = 5
    spans = np.array([[1000, 3000, 500], [2000, 1000, 1000],
                      [1500, 2000, 300], [1000, 1000, 4000],
                      [4000, 1000, 200]], np.int64)  # (blocks, phases)
    t0 = 10 ** 15 + np.arange(TIMED_STEPS)[:, None, None] * 10 ** 6
    clock = t0 + np.concatenate(
        [np.zeros((TIMED_STEPS, blocks, 1), np.int64),
         np.broadcast_to(np.cumsum(spans, axis=1), (TIMED_STEPS, blocks, 3))],
        axis=2)
    got = phase_split(torch.from_numpy(clock), name)
    assert set(got) == {*PHASES[name], "matvec phase", "step", "tick_ns"}
    assert got["node rows"] == {"max_us": 4.0, "median_us": 1.5,
                                "mean_us": 1.9}
    assert got["arc rows"]["max_us"] == 3.0
    assert got["barrier"]["median_us"] == 0.5
    assert got["matvec phase"]["max_us"] == 5.0  # block 4: 4000 + 1000
    assert got["step"]["max_us"] == 6.0
    assert got["tick_ns"] == 200  # 5000 -> 5200 ns, block 4
