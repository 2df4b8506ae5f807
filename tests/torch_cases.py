"""Shared instances and fixtures of the ``test_torch_*`` files.

The instances are the shapes of ``tests/test_fused.py`` (random, degree-zero
nodes, a skewed hub), made with numpy from a seed so that the JAX package
and the PyTorch port get the same inputs.
"""

import numpy as np
import pytest
import torch

#: the device of every CPU test: the port's entry points default to "cuda"
CPU = torch.device("cpu")


def random_kkt(rng, m=700, p=300):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    return d, u, v, p


def degree_zero_kkt(rng, m=50, p=40):
    u = rng.integers(0, 10, m).astype(np.int32)  # only nodes 0..9 as tails
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 2.0, m).astype(np.float32)
    return d, u, v, p


def hub_kkt(rng, m=900, p=150):
    u = np.where(rng.random(m) < 0.6, 0, rng.integers(0, p, m)).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 4.0, m).astype(np.float32)
    return d, u, v, p


CASES = {"random": random_kkt, "degree_zero": degree_zero_kkt, "hub": hub_kkt}


def wide_hub_kkt(rng, m=1500, p=100):
    """Node 0 is the tail of ~80 % of the arcs: a degree past 4·256, so
    each thread of its node row folds more than four entries."""
    u = np.where(rng.random(m) < 0.8, 0, rng.integers(0, p, m)).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 4.0, m).astype(np.float32)
    return d, u, v, p


def self_loop_kkt(rng, m=700, p=300):
    """random_kkt with every 7th arc a loop, u == v: its two incidence
    entries, + and -, lie in one node's segment."""
    d, u, v, p = random_kkt(rng, m, p)
    v[::7] = u[::7]
    return d, u, v, p


#: the instances of the node walk's tests (tests/test_torch_node_walk.py and
#: the persistent passes' card tests)
NODE_WALK_CASES = {"random": random_kkt, "degree_zero": degree_zero_kkt,
                   "wide_hub": wide_hub_kkt, "self_loop": self_loop_kkt}

#: threads of a node row's block (``tpl::kThreads``)
NODE_ROW_THREADS = 256


def node_rows_in_kernel_order(ptr, ent, x_a, scale=None):
    """``y_n = E·x_a`` rounded as ``kkt_node_row`` (``csrc/lanczos_common.cuh``)
    rounds it, in ``x_a``'s dtype: thread t of a node's block folds the
    node's entries ``ptr[i] + t``, ``+ 256``, ... in turn, adding ``x_a[a]``
    for entry ``a`` and subtracting ``x_a[~a]`` for ``~a`` (each times
    ``scale`` first, as K2's ``ScaledLoad``); then block_sum's fixed tree adds
    ``sh[t + s]`` into ``sh[t]`` for s = 128, 64, ..., 1."""
    ptr, ent = ptr.long(), ent.long()
    start, deg = ptr[:-1], ptr[1:] - ptr[:-1]
    p, threads = deg.numel(), NODE_ROW_THREADS
    acc = torch.zeros((p, threads), dtype=x_a.dtype)
    t = torch.arange(threads)
    rounds = -(-int(deg.max()) // threads) if p else 0
    for r in range(rounds):
        off = r * threads + t
        live = off[None, :] < deg[:, None]
        a = ent[torch.where(live, start[:, None] + off[None, :], 0)]
        x = x_a[torch.where(a >= 0, a, ~a)]
        if scale is not None:
            x = x * torch.as_tensor(scale, dtype=x_a.dtype)
        acc = torch.where(live, torch.where(a >= 0, acc + x, acc - x), acc)
    s = threads // 2
    while s:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


#: lanes of a warp; a warp row's lane holds NODE_ROW_THREADS // WARP_LANES
#: partials
WARP_LANES = 32


def node_rows_in_warp_order(ptr, ent, x_a, scale=None):
    """``y_n = E·x_a`` rounded as ``kkt_node_row_warp``
    (``csrc/lanczos_common.cuh``) rounds it, done literally lane by lane:
    lane l of a node's warp holds the 8 partials of the virtual threads vt =
    l + 32 r. Each round the lane loads its entries ``ptr[i] + l + 32 r +
    256 i`` (r = 0..7), then gathers, then adds ``x_a[a]`` for ``a`` and
    subtracts ``x_a[~a]`` for ``~a`` into partial r (each times ``scale``
    first). Then the register levels: ``acc[r] += acc[r + s]`` for r < s, s
    = 4, 2, 1; then the shuffle levels s = 16, 8, 4, 2, 1: lane l adds what
    ``__shfl_down_sync`` hands it, lane l + s's value, or its own where l + s
    is past the warp. Lane 0's value is the row."""
    ptr, ent = ptr.long(), ent.long()
    start, deg = ptr[:-1], ptr[1:] - ptr[:-1]
    p, lanes = deg.numel(), WARP_LANES
    per = NODE_ROW_THREADS // lanes
    acc = torch.zeros((p, lanes, per), dtype=x_a.dtype)
    vt = torch.arange(lanes)[:, None] + lanes * torch.arange(per)[None, :]
    rounds = -(-int(deg.max()) // NODE_ROW_THREADS) if p else 0
    for i in range(rounds):
        off = (vt + NODE_ROW_THREADS * i)[None]  # (1, lanes, per)
        live = off < deg[:, None, None]
        a = ent[torch.where(live, start[:, None, None] + off, 0)]
        x = x_a[torch.where(a >= 0, a, ~a)]
        if scale is not None:
            x = x * torch.as_tensor(scale, dtype=x_a.dtype)
        acc = torch.where(live, torch.where(a >= 0, acc + x, acc - x), acc)
    parts = list(acc.unbind(dim=2))  # per (p, lanes) partials, r = 0..7
    s = per // 2
    while s:
        for r in range(s):
            parts[r] = parts[r] + parts[r + s]
        s //= 2
    val = parts[0]
    lane = torch.arange(lanes)
    s = lanes // 2
    while s:
        src = lane + s
        shuffled = torch.where(src < lanes, val[:, src.clamp(max=lanes - 1)],
                               val)
        val = val + shuffled
        s //= 2
    return val[:, 0]


def breakdown_kkt():
    """All arcs share their endpoints, so the Krylov space of b = e_1 is
    tiny and pass one breaks down after a few steps: (d, u, v, p, b)."""
    m, p = 130, 130
    b = np.zeros(m + p, np.float32)
    b[0] = 1.0
    return (np.full(m, 2.0, np.float32), np.zeros(m, np.int32),
            np.ones(m, np.int32), p, b)


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: the kernels in ``csrc/`` run only on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --- K15, the CSR SpMV (csrc/csr_spmv.cu) -----------------------------------


def csr_kkt(rng):
    """The assembled KKT of a hub instance: arc rows of 3 nonzeros, node
    rows of ~100, and node 0's row past the plan's budget of 1,024."""
    m, p = 4000, 50
    u = np.where(rng.random(m) < 0.4, 0, rng.integers(0, p, m))
    v = (u + 1 + rng.integers(0, p - 1, m)) % p
    j = np.arange(m)
    rows = np.concatenate([j, u + m, v + m, j, j])
    cols = np.concatenate([j, j, j, u + m, v + m])
    return m + p, m + p, rows, cols


def csr_empty_rows(rng):
    """Rows of 0 to 9 nonzeros, half of them empty, an empty last row."""
    n = 3000
    lengths = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 10, n))
    lengths[-1] = 0
    rows = np.repeat(np.arange(n), lengths)
    return n, n, rows, rng.integers(0, n, rows.size)


def csr_all_empty(rng):
    """2,500 rows and no nonzero: blocks of 1,024 empty rows."""
    return 2500, 700, np.zeros(0, np.int64), np.zeros(0, np.int64)


def csr_long_row(rng):
    """Row 0 holds 100,000 nonzeros, rows 1..3,000 one each."""
    n_cols = 100_000
    rows = np.concatenate([np.zeros(n_cols, np.int64), np.arange(1, 3001)])
    cols = np.concatenate([np.arange(n_cols), rng.integers(0, n_cols, 3000)])
    return 3001, n_cols, rows, cols


def csr_hofstadter(rng):
    """The Hofstadter Laplacian's pattern on a 24 × 24 torus: 5 a row."""
    from two_pass_lanczos_tpu_torch.models import hofstadter_triplets
    n, rows, cols, _ = hofstadter_triplets(24, 8)
    return n, n, rows, cols


#: the sparsity patterns of K15's tests: (n_rows, n_cols, rows, cols)
CSR_CASES = {"kkt": csr_kkt, "empty_rows": csr_empty_rows,
             "all_empty": csr_all_empty, "long_row": csr_long_row,
             "hofstadter": csr_hofstadter}


def csr_matrix(name, dtype, seed=0, device=CPU):
    """(the SortedCOO of CSR_CASES[name] with values drawn in ``dtype``,
    an x of its columns in ``dtype``), both on ``device``."""
    from two_pass_lanczos_tpu_torch.ops.spmv import csr_from_triplets
    rng = np.random.default_rng(seed)
    n_rows, n_cols, rows, cols = CSR_CASES[name](rng)
    np_dt = torch.empty((), dtype=dtype).numpy().dtype

    def draw(size):
        out = rng.standard_normal(size)
        if np_dt.kind == "c":
            out = out + 1j * rng.standard_normal(size)
        return out.astype(np_dt)

    a = csr_from_triplets(n_rows, n_cols, rows, cols, draw(rows.size),
                          device=device)
    return a, torch.from_numpy(draw(n_cols)).to(device)


def csr_rows_in_kernel_order(a, x):
    """``y = A·x`` rounded as ``csr_spmv_kernel`` (``csrc/csr_spmv.cu``)
    rounds it, in the matrix's dtype, from the plan ``a.blocks``: in a block
    of R rows, L = the largest power of two ≤ threads / R lanes a row; lane
    l folds the products ``vals[i] · x[cols[i]]`` (a complex one as ``(ar·xr
    − ai·xi, ar·xi + ai·xr)``, each operation rounded) of the row's entries
    l, l + L, ... in turn into a zero; then the warp levels ``v[j] += v[j +
    s]`` for s = min(L, 32)/2 .. 1 within each warp of the row, then the
    same over the row's L/32 warp sums. Real and imaginary parts alike, in
    NumPy, one operation at a time. (256 threads a block, as
    ``tpl::kThreads``.)"""
    threads = NODE_ROW_THREADS
    indptr, blocks = a.indptr.cpu().numpy(), a.blocks.cpu().numpy()
    vals = a.vals.cpu().numpy()
    xs = x.cpu().numpy()[a.cols.cpu().numpy()]
    if np.iscomplexobj(vals):
        vr, vi, xr, xi = vals.real, vals.imag, xs.real, xs.imag
        prods = (np.subtract(vr * xr, vi * xi), np.add(vr * xi, vi * xr))
    else:
        prods = (np.multiply(vals, xs),)
    out = [np.zeros(a.shape[0], p.dtype) for p in prods]
    for b in range(blocks.size - 1):
        r0, r1 = int(blocks[b]), int(blocks[b + 1])
        lanes = threads
        while lanes > 1 and lanes * (r1 - r0) > threads:
            lanes //= 2
        width = min(lanes, WARP_LANES)
        for r in range(r0, r1):
            s, e = int(indptr[r]), int(indptr[r + 1])
            for prod, y in zip(prods, out):
                acc = np.zeros(lanes, prod.dtype)
                for i in range(s, e, lanes):
                    chunk = prod[i:min(i + lanes, e)]
                    acc[:chunk.size] = acc[:chunk.size] + chunk
                acc = acc.reshape(-1, width)  # a row of a warp each
                step = width // 2
                while step:
                    acc[:, :step] = acc[:, :step] + acc[:, step:2 * step]
                    step //= 2
                sums = acc[:, 0].copy()
                step = sums.size // 2
                while step:
                    sums[:step] = sums[:step] + sums[step:2 * step]
                    step //= 2
                y[r] = sums[0]
    y = out[0] if len(out) == 1 else out[0] + 1j * out[1]
    return torch.from_numpy(y.astype(vals.dtype))

