"""K15, the CSR SpMV of the sparse operators (``csrc/csr_spmv.cu``): its
row-block plan on the CPU, and the kernel on a card.

The CPU tests hold the plan (``ops/spmv.row_blocks``), the places that
build it (``csr_from_triplets``, ``SortedCOO.to``, the row-sharded
operator's parts) and the emulation of the kernel's order of summation
(``torch_cases.csr_rows_in_kernel_order``). The tests marked
``requires_cuda`` skip without a GPU and hold the kernel, in f32, f64, c64
and c128, bitwise to that emulation, within a stated bound of the plain
version, and to one launch a product. The file imports neither jax nor the
JAX package::

    python -m pytest --noconftest tests/test_torch_csr_spmv.py -m requires_cuda
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from torch_cases import (  # noqa: F401
    CPU,
    CSR_CASES,
    csr_matrix,
    csr_rows_in_kernel_order,
    cuda_device,
    random_kkt,
)
from two_pass_lanczos_tpu_torch import (
    SparseOperator,
    lanczos_pass_two_with_basis,
    lanczos_standard,
    solve_fAb,
)
from two_pass_lanczos_tpu_torch.models import hofstadter_triplets
from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES, reset_launches
from two_pass_lanczos_tpu_torch.ops.spmv import (
    ROW_BLOCK_NNZ,
    coo_spmv,
    coo_spmv_plain,
    csr_from_triplets,
    row_blocks,
    row_sum_bound,
)
from two_pass_lanczos_tpu_torch.ops.spmv_kernel import csr_spmv_cuda
from two_pass_lanczos_tpu_torch.parallel.sharded import ShardedSparseOperator
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _indptr(lengths):
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def _check_plan(indptr, blocks, budget):
    """Every row once, in order; each block within the budget's nonzeros
    and rows, or one longer row alone."""
    n = indptr.size - 1
    assert blocks.dtype == np.int64 and blocks[0] == 0 and blocks[-1] == n
    assert (np.diff(blocks) > 0).all()
    for r0, r1 in zip(blocks[:-1], blocks[1:]):
        nnz = indptr[r1] - indptr[r0]
        assert (nnz <= budget and r1 - r0 <= budget) or r1 - r0 == 1


PLAN_LENGTHS = {
    "ones": [1] * 5000,
    "threes_and_hubs": [3] * 3000 + [866] * 40 + [2000, 5, 1500],
    "empty_between": [0, 0, 4, 0, 2000, 0, 0, 7] * 300,
    "all_empty": [0] * 2500,
    "one_long_row": [100_000] + [1] * 3000,
    "budget_exact": [ROW_BLOCK_NNZ, ROW_BLOCK_NNZ, 1, ROW_BLOCK_NNZ - 1],
    "single_row": [17],
}


@pytest.mark.parametrize("lengths", list(PLAN_LENGTHS.values()),
                         ids=list(PLAN_LENGTHS))
@pytest.mark.parametrize("budget", [8, 256, ROW_BLOCK_NNZ])
def test_row_blocks_cover_every_row_once_within_budget(lengths, budget):
    indptr = _indptr(lengths)
    _check_plan(indptr, row_blocks(indptr, budget), budget)


def test_row_blocks_of_zero_rows_is_no_block():
    assert row_blocks(np.zeros(1, np.int64)).tolist() == [0]


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 2500])
def test_row_blocks_of_empty_rows_fill_blocks_of_budget_rows(n):
    blocks = row_blocks(np.zeros(n + 1, np.int64))
    want = list(range(0, n, ROW_BLOCK_NNZ)) + [n]
    assert blocks.tolist() == want  # the last block partly full


def test_row_blocks_pack_greedily_and_give_long_rows_a_block_alone():
    lengths = [300, 300, 300, 300, 2000, 1, 1, 1024, 0, 0]
    # 900 | 300 (2,000 more would pass 1,024) | 2,000 alone | 1 + 1 | a
    # full 1,024 with the empty rows after it
    assert row_blocks(_indptr(lengths)).tolist() == [0, 3, 4, 5, 7, 10]
    # the last block only partly full
    assert row_blocks(_indptr([3] * 700)).tolist() == [0, 341, 682, 700]


def test_the_kkt_plan_paces_by_nonzeros():
    rng = np.random.default_rng(3)
    d, u, v, p = random_kkt(rng, m=6000, p=4)  # node rows of ~3,000
    arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                       num_arcs=len(d))
    a = kkt_sorted_coo(arrays, dtype=np.float32, device=CPU)
    blocks = a.blocks.numpy()
    _check_plan(a.indptr.numpy(), blocks, ROW_BLOCK_NNZ)
    sizes = np.diff(blocks)
    assert sizes[0] == ROW_BLOCK_NNZ // 3  # 341 arc rows of 3
    assert (sizes[-p:] == 1).all()  # each node row a block of its own


@pytest.mark.parametrize("name", list(CSR_CASES))
def test_csr_from_triplets_and_to_carry_the_plan(name):
    a, _ = csr_matrix(name, torch.float64)
    want = row_blocks(a.indptr.numpy())
    assert np.array_equal(a.blocks.numpy(), want)
    moved = a.to("cpu")
    assert np.array_equal(moved.blocks.numpy(), want)
    assert moved.blocks.dtype == torch.int64


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sharded_parts_carry_their_plans(world):
    n, rows, cols, vals = hofstadter_triplets(12, 4, shift=0.5)
    for rank in range(world):
        mesh = types.SimpleNamespace(rank=rank, size=world, device=CPU)
        sop = ShardedSparseOperator(n, rows, cols, vals, mesh)
        for part in (sop.owned, sop.remote):
            assert np.array_equal(part.blocks.numpy(),
                                  row_blocks(part.indptr.numpy()))
            assert part.blocks[-1] == part.shape[0]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(CSR_CASES))
def test_cpu_coo_spmv_is_the_plain_version(name, dtype):
    a, x = csr_matrix(name, dtype)
    y = coo_spmv(a, x)
    assert torch.equal(y, coo_spmv_plain(a, x))
    assert y.dtype == dtype and y.shape == (a.shape[0],)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(CSR_CASES))
def test_kernel_order_emulation_within_the_bound_of_the_plain_sum(name,
                                                                 dtype):
    a, x = csr_matrix(name, dtype, seed=1)
    emulated = csr_rows_in_kernel_order(a, x)
    gap = (emulated - coo_spmv_plain(a, x)).abs().double()
    assert emulated.dtype == dtype
    assert bool((gap <= row_sum_bound(a, x)).all())


def test_kernel_order_emulation_of_serial_rows_is_the_plain_sum():
    # blocks of more than 128 rows sum each row serially, in CSR order, as
    # the plain version's segment_reduce does on the CPU
    a, x = csr_matrix("hofstadter", torch.float32, seed=2)
    assert torch.equal(csr_rows_in_kernel_order(a, x), coo_spmv_plain(a, x))


def test_csr_spmv_cuda_refuses_a_matrix_on_the_cpu():
    a, x = csr_matrix("kkt", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        csr_spmv_cuda(a, x)
    with pytest.raises(ValueError, match="instances"):
        csr_spmv_cuda(dataclasses.replace(a, vals=a.vals.half()), x.half())
    with pytest.raises(ValueError, match="int64"):
        dataclasses.replace(a, cols=a.cols.int())


@pytest.mark.parametrize("field, bad", [
    ("cols", lambda t: t.int()), ("indptr", lambda t: t.int()),
    ("blocks", lambda t: t.int()),
    ("vals", lambda t: torch.stack([t, t], dim=1)[:, 0]),
    ("rows", lambda t: torch.stack([t, t], dim=1)[:, 0])])
def test_sorted_coo_refuses_tensors_the_kernel_cannot_read(field, bad):
    a, _ = csr_matrix("kkt", torch.float32)
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(a, **{field: bad(getattr(a, field))})


# --- on a card ----------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(CSR_CASES))
def test_csr_spmv_kernel_order_bits_and_plain_bound_on_card(name, dtype,
                                                            cuda_device):
    a_cpu, x_cpu = csr_matrix(name, dtype, seed=4)
    a, x = a_cpu.to(cuda_device), x_cpu.to(cuda_device)
    reset_launches()
    y = coo_spmv(a, x)
    again = coo_spmv(a, x)
    torch.cuda.synchronize()
    assert LAUNCHES["csr_spmv"] == 2
    assert y.dtype == dtype and y.shape == (a.shape[0],)
    assert torch.equal(y, again)  # two calls, the same bits
    # the documented order, bit for bit
    assert torch.equal(y.cpu(), csr_rows_in_kernel_order(a_cpu, x_cpu))
    # another order of the same sums (the plain version on the card)
    gap = (y - coo_spmv_plain(a, x)).abs().double().cpu()
    assert bool((gap <= row_sum_bound(a_cpu, x_cpu)).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_sparse_operator_two_pass_replays_its_basis_on_card(dtype,
                                                            cuda_device):
    """A KKT for the real dtypes, the Hofstadter Laplacian for the complex
    ones: pass two regenerates pass one's basis bit for bit, one K15
    launch a product (2k - 1 a two-pass solve), the same bits twice."""
    k = 30
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    if dtype.is_complex:
        n, rows, cols, vals = hofstadter_triplets(32, 8, shift=0.5)
        coo = csr_from_triplets(n, n, rows, cols, vals.astype(np_dt),
                                device=CPU)
    else:
        rng = np.random.default_rng(5)
        d, u, v, p = random_kkt(rng, m=3000, p=200)
        arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                           num_arcs=len(d))
        coo = kkt_sorted_coo(arrays, dtype=np_dt, device=CPU)
        n = coo.shape[0]
    op = SparseOperator(coo, device=cuda_device)
    rng = np.random.default_rng(6)
    b_np = rng.standard_normal(n) + (1j * rng.standard_normal(n)
                                     if dtype.is_complex else 0)
    b = torch.from_numpy(b_np.astype(np_dt)).to(cuda_device)
    dec, v1 = lanczos_standard(op, b, k)
    _, v2 = lanczos_pass_two_with_basis(
        op, b, dec, torch.ones(k, dtype=b.dtype, device=cuda_device))
    steps = dec.steps()
    assert steps == k and torch.equal(v1[:steps], v2[:steps])
    reset_launches()
    x = solve_fAb(op, b, k=k, f="inv")
    torch.cuda.synchronize()
    assert {name: c for name, c in LAUNCHES.items() if c} == {
        "csr_spmv": 2 * k - 1}
    assert torch.equal(x, solve_fAb(op, b, k=k, f="inv"))


@pytest.mark.requires_cuda
def test_csr_spmv_cuda_refuses_wrong_inputs_on_card(cuda_device):
    a, x = csr_matrix("kkt", torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="x"):
        csr_spmv_cuda(a, x.double())
    with pytest.raises(ValueError, match="x"):
        csr_spmv_cuda(a, x[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmv_cuda(a, torch.stack([x, x], dim=1)[:, 0])
    with pytest.raises(ValueError, match="x"):
        csr_spmv_cuda(a, x.cpu())
    # the dispatch makes a strided x contiguous; the same bits
    strided = torch.stack([x, x], dim=1)[:, 0]
    assert torch.equal(coo_spmv(a, strided), coo_spmv(a, x))
