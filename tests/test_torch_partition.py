"""The port's row partition (``parallel/partition.py``) against the JAX
package's: ``snake_partition`` and ``build_local_blocks_split`` bitwise on
random triplets and on a KKT of 500 arcs over 1, 2, 3 and 8 ranks, and the
balance assertions of ``tests/test_sharded.py::test_snake_partition_balance``.
Both sides are NumPy; nothing runs on a device."""

import numpy as np
import pytest

from two_pass_lanczos_tpu.parallel import partition as jax_part

from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.parallel import RowPartition, snake_partition
from two_pass_lanczos_tpu_torch.parallel import partition as port_part

NDEV = [1, 2, 3, 8]


def _random_triplets(seed=0, n=301, nnz=2000):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    # a few heavy rows, as a KKT's node rows
    rows[:400] = rng.integers(0, 7, 400)
    return n, rows, cols, rng.standard_normal(nnz)


def _kkt_triplets(arcs=500):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=1)
    m = inst.num_arcs
    j = np.arange(m, dtype=np.int64)
    u = inst.arc_u.astype(np.int64) + m
    v = inst.arc_v.astype(np.int64) + m
    ones = np.ones(m)
    return (m + inst.num_nodes, np.concatenate([j, u, v, j, j]),
            np.concatenate([j, j, j, u, v]),
            np.concatenate([inst.quad_costs, ones, -ones, ones, -ones]))


TRIPLETS = {"random": _random_triplets, "kkt500": _kkt_triplets}


def _assert_same_partition(a, b):
    for name in ("perm", "inv_perm", "nnz_per_dev"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.rows_per, a.ndev, a.n_orig, a.n_pad) == (
        b.rows_per, b.ndev, b.n_orig, b.n_pad)


@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("case", sorted(TRIPLETS))
def test_snake_partition_bitwise_jax(case, ndev):
    n, rows, _, _ = TRIPLETS[case]()
    nnz = np.bincount(rows, minlength=n)
    ours = snake_partition(nnz, ndev)
    assert isinstance(ours, RowPartition)
    _assert_same_partition(ours, jax_part.snake_partition(nnz, ndev))


@pytest.mark.parametrize("ndev", NDEV)
@pytest.mark.parametrize("case", sorted(TRIPLETS))
def test_local_blocks_split_bitwise_jax(case, ndev):
    n, rows, cols, vals = TRIPLETS[case]()
    part = snake_partition(np.bincount(rows, minlength=n), ndev)
    ours = port_part.build_local_blocks_split(rows, cols, vals, part)
    ref = jax_part.build_local_blocks_split(
        rows, cols, vals, jax_part.snake_partition(
            np.bincount(rows, minlength=n), ndev))
    for mine, theirs in zip(ours, ref):  # owned, remote
        for a, b in zip(mine, theirs):   # lr, lc, lv
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # each rank's unpadded blocks are the head of its padded rows; the rest
    # is padding
    mine = [port_part.local_blocks(rows, cols, vals, part, d)
            for d in range(ndev)]
    assert sum(len(blk[0]) for blocks in mine for blk in blocks) == len(rows)
    for which, (lr, lc, lv) in enumerate(ours):
        for d in range(ndev):
            got = mine[d][which]
            c = len(got[0])
            for a, b in zip((lr, lc, lv), got):
                np.testing.assert_array_equal(a[d, :c], b)
            assert (lr[d, c:] == part.rows_per - 1).all()
            assert (lv[d, c:] == 0).all()
            assert (np.diff(got[0]) >= 0).all()
    if ndev == 1:
        assert len(mine[0][1][0]) == 0


def test_snake_partition_balance():
    # KKT-like degree profile: many light rows, few heavy ones.
    nnz = np.concatenate([np.full(1000, 3), np.full(40, 50)])
    part = snake_partition(nnz, 8)
    assert part.n_pad % 8 == 0
    assert part.perm.shape == (part.n_pad,)
    np.testing.assert_array_equal(np.sort(part.perm), np.arange(part.n_pad))
    spread = part.nnz_per_dev.max() - part.nnz_per_dev.min()
    assert spread <= 60, f"nnz imbalance too large: {part.nnz_per_dev}"
