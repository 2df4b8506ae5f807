"""Row partitioning of sparse operators across the ranks of a mesh.

Counterpart of ``two_pass_lanczos_tpu/parallel/partition.py``, copied
(NumPy only; the port imports nothing of the JAX package).

The KKT matrix is pathologically unbalanced for naive contiguous row splits:
arc rows carry exactly 3 nonzeros while node rows carry the node degree
(~2·arcs/nodes, i.e. hundreds); a contiguous split hands one rank nearly
half the nnz. Since the Lanczos iteration is invariant under a symmetric
permutation ``P·A·Pᵀ`` (solve with ``P·b``, unpermute the result), rows are
balanced by *permuting* them so each equal-size vector shard carries
near-equal nnz:

* sort rows by nnz descending,
* deal them to ranks in serpentine (snake) order — the classic LPT-style
  balance guarantee with exactly equal row counts per rank,
* sort each rank's rows ascending (gather locality), and concatenate into
  the global permutation.

This keeps the *vector* sharding uniform (one all-gather of equal shards)
while the *work* sharding is balanced (what the SpMV needs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["RowPartition", "snake_partition", "build_local_blocks_split",
           "local_blocks"]


class RowPartition(NamedTuple):
    """A symmetric-permutation row partition.

    ``perm[i]`` is the original row index placed at permuted position ``i``;
    positions ``[d·rows_per : (d+1)·rows_per)`` live on rank ``d``.
    ``n_orig ≤ n_pad = ndev · rows_per`` (phantom zero rows pad the tail).
    """

    perm: np.ndarray  # (n_pad,) int64
    inv_perm: np.ndarray  # (n_pad,) int64
    rows_per: int
    ndev: int
    n_orig: int
    nnz_per_dev: np.ndarray  # (ndev,) int64 — diagnostics

    @property
    def n_pad(self) -> int:
        return self.rows_per * self.ndev


def snake_partition(nnz_per_row: np.ndarray, ndev: int) -> RowPartition:
    """Balance rows over ``ndev`` ranks by serpentine dealing."""
    n_orig = int(nnz_per_row.shape[0])
    rows_per = -(-n_orig // ndev)
    n_pad = rows_per * ndev
    counts = np.zeros(n_pad, dtype=np.int64)
    counts[:n_orig] = nnz_per_row
    order = np.argsort(-counts, kind="stable")

    bins = np.empty((ndev, rows_per), dtype=np.int64)
    for idx in range(n_pad):
        rnd, pos = divmod(idx, ndev)
        dev = pos if rnd % 2 == 0 else ndev - 1 - pos
        bins[dev, rnd] = order[idx]
    bins.sort(axis=1)  # ascending original ids within each rank

    perm = bins.reshape(-1)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_pad)
    nnz_per_dev = counts[bins].sum(axis=1)
    return RowPartition(
        perm=perm,
        inv_perm=inv_perm,
        rows_per=rows_per,
        ndev=ndev,
        n_orig=n_orig,
        nnz_per_dev=nnz_per_dev,
    )


def local_blocks(rows, cols, vals, part: RowPartition, rank: int):
    """Rank ``rank``'s rows of the operator, split into OWNED-column and
    REMOTE-column triplets, unpadded: ``((lr, lc_local, lv), (lr,
    lc_global, lv))``, int64 indices, local rows ascending and each row's
    entries in triplet order. These are the real entries of rank ``rank``
    in :func:`build_local_blocks_split`, in its order."""
    rows = np.asarray(rows, dtype=np.int64)
    vals = np.asarray(vals)
    rp = part.rows_per
    pos_r = part.inv_perm[rows]
    mine = np.flatnonzero(pos_r // rp == rank)
    mine = mine[np.argsort(pos_r[mine], kind="stable")]
    lrow = pos_r[mine] - rank * rp
    pos_c = part.inv_perm[np.asarray(cols, dtype=np.int64)[mine]]
    lv = vals[mine]
    owned = pos_c // rp == rank
    return ((lrow[owned], pos_c[owned] - rank * rp, lv[owned]),
            (lrow[~owned], pos_c[~owned], lv[~owned]))


def build_local_blocks_split(rows, cols, vals, part: RowPartition,
                             pad_multiple: int = 128):
    """Per-rank local blocks split into OWNED-column and REMOTE-column
    parts (SURVEY §7 stage 5: halo exchange *overlapped with* the
    diagonal-block SpMV).

    The owned part touches only columns this rank's vector shard already
    holds, so it does not wait for the all-gather of the Krylov vector:
    the sharded matvec computes it while the gather is in flight, and the
    remote part once the gathered vector lands.

    Returns two triples of ``(ndev, ·)`` stacked arrays:

    * owned: ``(lr, lc_local, lv)`` with ``lc_local`` indexing the *local*
      shard (0..rows_per-1);
    * remote: ``(lr, lc_global, lv)`` with ``lc_global`` indexing the
      all-gathered vector.

    Both keep local rows ascending and pad with the last local row / col 0
    / val 0 to a multiple of ``pad_multiple`` (the TPU's lanes); rank d's
    real entries come first, and :func:`local_blocks` gives them alone.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    pos_r = part.inv_perm[rows]
    pos_c = part.inv_perm[cols]
    dev = pos_r // part.rows_per
    lrow = pos_r - dev * part.rows_per
    owned = (pos_c // part.rows_per) == dev

    order = np.lexsort((lrow, dev))
    dev, lrow, pos_c, vals, owned = (
        dev[order], lrow[order], pos_c[order], vals[order], owned[order])

    def pack(mask, local_cols: bool):
        d_m, lrow_m, pos_m, val_m = dev[mask], lrow[mask], pos_c[mask], vals[mask]
        counts = np.bincount(d_m, minlength=part.ndev)
        mx = int(counts.max()) if counts.size else 0
        mx = max(((mx + pad_multiple - 1) // pad_multiple) * pad_multiple,
                 pad_multiple)
        lr = np.full((part.ndev, mx), part.rows_per - 1, dtype=np.int32)
        lc = np.zeros((part.ndev, mx), dtype=np.int32)
        lv = np.zeros((part.ndev, mx), dtype=vals.dtype)
        starts = np.concatenate([[0], np.cumsum(counts)])
        cvals = (pos_m - d_m * part.rows_per) if local_cols else pos_m
        for d in range(part.ndev):
            s, e = starts[d], starts[d + 1]
            c = e - s
            lr[d, :c] = lrow_m[s:e]
            lc[d, :c] = cvals[s:e]
            lv[d, :c] = val_m[s:e]
        return lr, lc, lv

    return pack(owned, True), pack(~owned, False)
