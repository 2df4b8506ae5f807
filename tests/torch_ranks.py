"""The rank side of the sharded solvers' tests, and the spawner that runs it.

The sharded solvers run in a process group, one process per rank, and a
pytest worker never joins one. A test hands :func:`spawn` its cases; every
rank is a fresh ``python tests/torch_ranks.py`` process that joins a gloo
(CPU) or NCCL (card) group through a ``FileStore`` under the test's
``tmp_path``, runs the cases in order and pickles their results. Several
cases share one spawn. The ranks import torch and the port only, never jax:
the tests compute the JAX package's values in the pytest process and compare
after the ranks return. A spawn that outlives its deadline is killed, and
the test fails instead of hanging.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: seconds a spawn may take, set-up included, before its ranks are killed
DEADLINE_S = 120


def _tail(path: Path, n: int = 3000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def spawn(world, cases, tmp_path, device="cpu", deadline=DEADLINE_S):
    """Run ``cases``, a list of ``(key, case name, kwargs)``, on ``world``
    ranks; returns one ``{key: result}`` dict per rank, in rank order.
    Raises ``AssertionError`` when a rank fails or the deadline passes."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pkl"
    with open(job, "wb") as fh:
        pickle.dump({"device": device, "cases": cases}, fh)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(r),
                 str(world), str(tmp / "store"), str(job), str(tmp)],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise AssertionError(
            f"{world} ranks outlived the {deadline} s deadline:\n"
            + "\n".join(_tail(log) for log in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(f"rank(s) {failed} of {world} failed:\n"
                             + "\n".join(_tail(logs[r]) for r in failed))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.out.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------------------
# The cases, run on every rank (torch and the port only)
# ---------------------------------------------------------------------------

def _np(t):
    """A tensor anywhere, or an array, as a NumPy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _mesh(device):
    from two_pass_lanczos_tpu_torch.parallel import make_mesh
    return make_mesh(device=device)


def _f32(device, d, u, v, p):
    from two_pass_lanczos_tpu_torch.parallel import ShardedFusedKKTSolver
    return ShardedFusedKKTSolver(d, u, v, p, _mesh(device))


def _df(device, d, u, v, p):
    from two_pass_lanczos_tpu_torch.parallel import DFShardedFusedKKTSolver
    return DFShardedFusedKKTSolver(d, u, v, p, _mesh(device))


def _dec(dec):
    return {"alphas": _np(dec.alphas), "betas": _np(dec.betas),
            "steps": dec.steps(), "b_norm": float(dec.b_norm)}


def case_mesh(device):
    """The mesh's fields, and what ``make_mesh`` refuses."""
    import torch.distributed as dist
    from two_pass_lanczos_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )
    mesh = make_mesh(device=device)
    try:
        make_mesh(mesh.size + 1, device=device)
        too_many = None
    except ValueError as e:
        too_many = str(e)
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "axis": mesh.axis, "device": str(mesh.device),
            "world": dist.get_world_size(), "too_many": too_many,
            "again": initialize_distributed(device=device)}


def case_matvec(device, d, u, v, p, x):
    return _f32(device, d, u, v, p).matvec(x)


def case_solve(device, d, u, v, p, b, k, f="inv", method="two_pass",
               packed=False, raw=False):
    s = _f32(device, d, u, v, p)
    rhs = s.pack(b) if packed else b
    x, dec = s.solve(rhs, k=k, f=f, method=method, raw=raw)
    if raw:
        x = {"xa": _np(x[0]), "xn": _np(x[1]), "m_d": s.m_d,
             "arc0": int(s.arc_idx[s.mesh.rank][0])}
    return dict(_dec(dec), x=x)


def case_chunked(device, d, u, v, p, b, k, chunk):
    s = _f32(device, d, u, v, p)
    dec, stopped = s.pass_one_chunked(s.pack(b), k, chunk=chunk)
    mono = s.pass_one(b, k)
    return dict(_dec(dec), stopped=stopped, mono=_dec(mono),
                launches=s._last_p1_launches)


def case_callback(device, d, u, v, p, b, k, stop_at, chunk):
    s = _f32(device, d, u, v, p)
    seen, views = [], []

    def cb(step, basis, scalars):
        alphas, betas = scalars
        views.append(basis is None and len(alphas) == step
                     and len(betas) == step - 1)
        seen.append(step)
        return step < stop_at

    x_cb, dec = s.solve(b, k=k, f="inv", callback=cb, callback_chunk=chunk)
    out = dict(_dec(dec), x=x_cb, seen=seen, views=all(views),
               p1_launches=s._last_p1_launches, p2_len=s._last_p2_len)
    x_ref, dec_ref = s.solve(b, k=stop_at, f="inv")
    out["ref"] = dict(_dec(dec_ref), x=x_ref)
    return out


def case_zero_chunked(device, d, u, v, p, k, chunk):
    s = _f32(device, d, u, v, p)
    zero = np.zeros(s.n, np.float32)
    dec, stopped = s.pass_one_chunked(s.pack(zero), k, chunk=chunk)
    x, dec2 = s.solve(zero, k=k, f="inv", callback=lambda *a: True,
                      callback_chunk=chunk)
    return {"steps": dec.steps(), "stopped": stopped,
            "steps_cb": dec2.steps(), "x": x}


def case_errors(device, d, u, v, p):
    """The messages of what the f32 solver refuses (None: no error)."""
    s = _f32(device, d, u, v, p)
    zero = np.zeros(s.n, np.float32)
    need_k = s.ONE_PASS_HBM_BUDGET // ((max(s.shard_sizes) + s.p) * 4) + 1
    calls = {
        "hbm": lambda: s.solve(zero, k=need_k, method="one_pass"),
        "callback_one_pass": lambda: s.solve(
            zero, k=4, method="one_pass", callback=lambda *a: True),
        "method": lambda: s.solve(zero, k=4, method="three_pass"),
        "shape": lambda: s.solve(zero[:-1], k=4),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = f"{type(e).__name__}: {e}"
    out["one_pass_bytes"] = s.one_pass_basis_bytes(7)
    out["budget"] = s.ONE_PASS_HBM_BUDGET
    out["shard_sizes"] = s.shard_sizes
    return out


def case_replay(device, d, u, v, p, b, k):
    """Pass two's v_s against pass one's on this rank, and the replicated
    values every rank must hold bit for bit."""
    import torch
    from two_pass_lanczos_tpu_torch.algorithms.core import (
        pass_one_last_vector,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import scaled_y
    s = _f32(device, d, u, v, p)
    bl = s.pack(b)
    st1 = torch.empty(2, s.n_local, device=s.device)
    st2 = torch.empty(2, s.n_local, device=s.device)
    dec = s.pass_one(bl, k, state=st1)
    x = s.pass_two(bl, dec, scaled_y(dec, "inv", k), state=st2)
    v1 = pass_one_last_vector(dec, st1)
    m = s.m_d
    return dict(_dec(dec), replay=bool(torch.equal(v1, st2[1])),
                node=_np(st1[1, m:]), x_node=_np(x[m:]))


def case_collectives(device, d, u, v, p, b, k):
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        collective_bytes,
        record_collectives,
    )
    s = _f32(device, d, u, v, p)
    with record_collectives() as log:
        x, dec = s.solve(b, k=k, f="inv")
    ops = log.ops()
    return {"ops": [(o.kind, o.dtype, o.shape, o.count) for o in ops],
            "bytes": collective_bytes(ops), "steps": dec.steps(),
            "width": max(s.shard_sizes), "calls": len(log.calls)}


def case_convert(device, d, u, v, p, b, k, arc_idx):
    """``sharded_solver_from_jax`` on an object with the JAX solver's
    host fields, and its refusal of another split."""
    from two_pass_lanczos_tpu_torch.convert import sharded_solver_from_jax
    mesh = _mesh(device)
    jax_like = SimpleNamespace(_kkt_arrays=(d, u, v, p), arc_idx=arc_idx)
    x, dec = sharded_solver_from_jax(jax_like, mesh).solve(b, k=k, f="inv")
    other = SimpleNamespace(_kkt_arrays=(d, u, v, p),
                            arc_idx=np.array_split(np.arange(len(d)),
                                                   mesh.size + 1))
    try:
        sharded_solver_from_jax(other, mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(_dec(dec), x=x, refused=refused)


def _coeffs(c):
    a64, b64, steps = c
    return {"alphas": np.asarray(a64), "betas": np.asarray(b64),
            "steps": int(steps)}


def case_df_solve(device, d, u, v, p, b, k, f="inv", packed=False,
                  pair=False):
    if pair:
        hi = np.asarray(d, np.float32)
        d = (hi, (np.asarray(d) - hi.astype(np.float64)).astype(np.float32))
    s = _df(device, d, u, v, p)
    rhs = s.pack(b) if packed else b
    x, c = s.solve(rhs, k=k, f=f)
    return dict(_coeffs(c), x=x)


def case_df_replay(device, d, u, v, p, b, k):
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_pass_one_last_vector,
    )
    s = _df(device, d, u, v, p)
    b2 = s.pack(b)
    st1 = torch.empty(2, 2, s.n_local, device=s.device)
    st2 = torch.empty(2, 2, s.n_local, device=s.device)
    coeffs = s.pass_one(b2, k, state=st1)
    y = torch.zeros(2, k, device=s.device)
    s.pass_two(b2, coeffs, y[0], y[1], state=st2)
    m = s.m_d
    return {"replay": bool(torch.equal(df_pass_one_last_vector(coeffs, st1),
                                       st2[1])),
            "coeffs": [_np(c) for c in coeffs], "node": _np(st1[1, :, m:])}


def case_df_collectives(device, d, u, v, p, b, k):
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        record_collectives,
    )
    s = _df(device, d, u, v, p)
    with record_collectives() as log:
        _, c = s.solve(b, k=k, f="inv")
    return {"ops": [(o.kind, o.dtype, o.shape, o.count) for o in log.ops()],
            "steps": int(c[2]), "width": max(s.shard_sizes)}


def case_df_convert(device, d, u, v, p, b, k, arc_idx, m, p_jax):
    from two_pass_lanczos_tpu_torch.convert import df_sharded_solver_from_jax
    mesh = _mesh(device)
    jax_like = SimpleNamespace(arc_idx=arc_idx, m=m, p=p_jax)
    s = df_sharded_solver_from_jax(jax_like, mesh, (d, u, v, p))
    x, c = s.solve(b, k=k, f="inv")
    try:
        df_sharded_solver_from_jax(jax_like, mesh, (d[:-1], u[:-1], v[:-1],
                                                    p))
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(_coeffs(c), x=x, refused=refused)


def case_card_path(device, d, u, v, p, b, d64, k):
    """On a card: the f32 and df sharded solves count only K7 / K12
    launches and agree with the single-device solvers."""
    import torch
    from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, FusedKKTSolver
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )
    s = _f32(device, d, u, v, p)
    bt = torch.from_numpy(b).to(s.device)
    reset_launches()
    x, dec = s.solve(bt, k=k, f="inv")
    torch.cuda.synchronize()
    f32_launches = dict(LAUNCHES)
    x1, dec1 = FusedKKTSolver(d, u, v, p, device=s.device).solve(
        bt, k=k, f="inv")
    sd = _df(device, d64, u, v, p)
    b64 = bt.double()
    reset_launches()
    xd, c = sd.solve(b64, k=k, f="inv")
    torch.cuda.synchronize()
    df_launches = dict(LAUNCHES)
    xd1, c1 = DFFusedKKTSolver(d64, u, v, p, device=s.device).solve(
        b64, k=k, f="inv")
    return {"f32_launches": f32_launches, "df_launches": df_launches,
            "x": x, "x1": _np(x1), "dec": _dec(dec), "dec1": _dec(dec1),
            "xd": xd, "xd1": _np(xd1), "c": _coeffs(c), "c1": _coeffs(c1)}


# --- the row-sharded ShardedSparseOperator ----------------------------------

def _sparse(device, spec):
    """The operator of ``spec``: ``{"kkt": (d, u, v, p), "dtype": ...}``
    through ``from_kkt_arrays``, or ``{"triplets": (n, rows, cols, vals)}``
    through the constructor."""
    from two_pass_lanczos_tpu_torch.parallel import ShardedSparseOperator
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays
    mesh = _mesh(device)
    if "kkt" in spec:
        d, u, v, p = spec["kkt"]
        arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                           num_arcs=len(d))
        return ShardedSparseOperator.from_kkt_arrays(
            arrays, mesh, dtype=spec.get("dtype", np.float64))
    n, rows, cols, vals = spec["triplets"]
    return ShardedSparseOperator(n, rows, cols, vals, mesh)


def case_sparse_matvec(device, spec, x):
    sop = _sparse(device, spec)
    return {"y": sop.matvec_distributed(x), "shape": sop.shape,
            "nnz": sop.nnz_per_device, "rows_per": sop.part.rows_per}


def case_sparse_solve(device, spec, b, k, f="exp", method="two_pass",
                      raw=False):
    sop = _sparse(device, spec)
    x, dec = sop.solve_fAb(b, k=k, f=f, method=method, raw=raw)
    return dict(_dec(dec), x=_np(x))


def case_sparse_chunked(device, spec, b, k, chunk):
    sop = _sparse(device, spec)
    _, mono = sop.solve_fAb(b, k=k, f="inv")
    dec, stopped = sop.pass_one_chunked(b, k, chunk=chunk)
    return dict(_dec(dec), stopped=stopped, mono=_dec(mono),
                launches=sop._last_p1_launches)


def case_sparse_callback(device, spec, b, k, stop_at, chunk):
    sop = _sparse(device, spec)
    seen, views = [], []

    def cb(step, basis, scalars):
        alphas, betas = scalars
        views.append(basis is None and len(alphas) == step
                     and len(betas) == step - 1)
        seen.append(step)
        return step < stop_at

    x_cb, dec = sop.solve_fAb(b, k=k, f="inv", callback=cb,
                              callback_chunk=chunk)
    out = dict(_dec(dec), x=x_cb, seen=seen, views=all(views),
               p1_launches=sop._last_p1_launches, p2_len=sop._last_p2_len)
    x_ref, dec_ref = sop.solve_fAb(b, k=stop_at, f="inv")
    out["ref"] = dict(_dec(dec_ref), x=x_ref)
    return out


def case_sparse_zero(device, spec, k, chunk):
    sop = _sparse(device, spec)
    zero = np.zeros(sop.shape[0])
    dec, stopped = sop.pass_one_chunked(zero, k, chunk=chunk)
    x, dec2 = sop.solve_fAb(zero, k=k, f="inv", callback=lambda *a: True,
                            callback_chunk=chunk)
    x1, dec3 = sop.solve_fAb(zero, k=k, f="inv")
    return {"steps": dec.steps(), "stopped": stopped,
            "steps_cb": dec2.steps(), "x": x, "steps_mono": dec3.steps(),
            "x_mono": x1}


def case_sparse_replay(device, spec, b, k):
    """Pass two's v_s against pass one's on this rank, and what every rank
    must hold bit for bit."""
    import torch
    from two_pass_lanczos_tpu_torch.algorithms.core import (
        pass_one_last_vector,
        pass_one_scan,
        pass_two_scan,
    )
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import scaled_y
    sop = _sparse(device, spec)
    bl = sop._prepare_b(b)
    st1 = torch.empty(2, bl.shape[0], dtype=bl.dtype, device=bl.device)
    st2 = torch.empty_like(st1)
    dec, _ = pass_one_scan(sop._matvec, bl, k, state=st1, dot=sop._dot)
    pass_two_scan(sop._matvec, bl, dec, scaled_y(dec, "inv", k), state=st2)
    return dict(_dec(dec), replay=bool(torch.equal(
        pass_one_last_vector(dec, st1), st2[1])))


def case_sparse_collectives(device, spec, b, k):
    """The collectives and markers of one two-pass solve, in order."""
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        collective_bytes,
        record_collectives,
    )
    sop = _sparse(device, spec)
    with record_collectives() as log:
        _, dec = sop.solve_fAb(b, k=k, f="inv")
    ops = log.ops()
    return {"ops": [(o.kind, o.dtype, o.shape, o.count) for o in ops],
            "bytes": collective_bytes(ops), "steps": dec.steps(),
            "events": list(log.events), "rows_per": sop.part.rows_per,
            "n_pad": sop.part.n_pad, "nnz": sop.nnz_per_device}


def case_sparse_errors(device, spec):
    """The messages of what the operator refuses (None: no error)."""
    sop = _sparse(device, spec)
    n = sop.shape[0]
    zero = np.zeros(n)
    calls = {
        "method": lambda: sop.solve_fAb(zero, k=4, method="three_pass"),
        "callback_one_pass": lambda: sop.solve_fAb(
            zero, k=4, method="one_pass", callback=lambda *a: True),
        "shape": lambda: sop.solve_fAb(zero[:-1], k=4),
        "chunk": lambda: sop.pass_one_chunked(zero, 4, chunk=0),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _raised(call):
    """The message of what ``call`` raises (None: no error)."""
    try:
        call()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _eig(res):
    return {"values": np.asarray(res.eigenvalues),
            "vectors": (None if res.eigenvectors is None
                        else np.asarray(res.eigenvectors)),
            "resid": np.asarray(res.residual_norms),
            "restarts": res.restarts, "converged": res.converged}


def case_sparse_eigsh(device, spec, **kwargs):
    """``ShardedSparseOperator.eigsh(**kwargs)``."""
    return _eig(_sparse(device, spec).eigsh(**kwargs))


def case_sparse_eigsh_errors(device, spec):
    sop = _sparse(device, spec)
    n = sop.shape[0]
    return {"which": _raised(lambda: sop.eigsh(nev=2, which="XX")),
            "v0": _raised(lambda: sop.eigsh(nev=2, v0=np.zeros(n)))}


def case_sparse_slq(device, spec, f, k, num_probes, key, probe="rademacher"):
    """``slq_trace`` (``f`` "x2" is t ↦ t², a callable), and its pass one
    on the same probes."""
    from two_pass_lanczos_tpu_torch import slq
    sop = _sparse(device, spec)
    fn = (lambda t: t * t) if f == "x2" else f
    res = sop.slq_trace(fn, k=k, num_probes=num_probes, key=key,
                        probe=probe)
    probes = slq._draw_probes(key, num_probes, sop.shape[0], sop.dtype,
                              probe)
    return {"estimate": float(res.estimate), "stderr": float(res.stderr),
            "samples": _np(res.samples), "probes": _np(probes),
            "dec": _dec_stack(sop._slq_pass_one(probes, k))}


def _dec_stack(dec):
    return {"alphas": _np(dec.alphas), "betas": _np(dec.betas),
            "steps": _np(dec.steps_taken), "b_norm": _np(dec.b_norm)}


def case_sparse_slq_errors(device, spec):
    sop = _sparse(device, spec)
    return {"num_probes": _raised(lambda: sop.slq_trace(
                "inv", k=4, num_probes=0, key=0)),
            "f": _raised(lambda: sop.slq_trace("nope", k=4, num_probes=2,
                                               key=0))}


def case_sparse_adaptive(device, spec, k, batch, target, max_probes, key):
    sop = _sparse(device, spec)
    res = sop.slq_trace_adaptive(lambda t: t * t, k=k, batch=batch,
                                 target_rel_stderr=target,
                                 max_probes=max_probes, key=key)
    return {"estimate": float(res.estimate), "m": int(res.samples.shape[0])}


def case_sparse_dos(device, spec, grid, sigma, k, num_probes, key):
    from two_pass_lanczos_tpu_torch import slq
    sop = _sparse(device, spec)
    phi = sop.slq_spectral_density(grid, sigma=sigma, k=k,
                                   num_probes=num_probes, key=key)
    probes = slq._draw_probes(key, num_probes, sop.shape[0], sop.dtype,
                              "gaussian")
    return {"phi": _np(phi), "probes": _np(probes)}


def case_sparse_chebyshev(device, spec, b, f, degree, interval=None):
    sop = _sparse(device, spec)
    out = {"x": sop.chebyshev_fAb(b, f, degree=degree, interval=interval)}
    if interval is None:
        out["interval"] = sop.estimate_interval()
    return out


def case_sparse_chebyshev_errors(device, spec):
    sop = _sparse(device, spec)
    return {"inv": _raised(lambda: sop.chebyshev_fAb(
        np.ones(sop.shape[0]), "inv", degree=10, interval=(-2.0, 2.0)))}


def case_sparse_block(device, spec, b_block, k, f="inv", raw=False):
    sop = _sparse(device, spec)
    x = sop.solve_fAb_block(b_block, k=k, f=f, raw=raw)
    return {"x": _np(x), "steps": sop._last_block_steps}


def case_sparse_block_errors(device, spec):
    sop = _sparse(device, spec)
    n = sop.shape[0]
    return {
        "ndim": _raised(lambda: sop.solve_fAb_block(np.ones(n), k=4)),
        "rows": _raised(lambda: sop.solve_fAb_block(np.ones((8, 2)), k=4)),
        "f": _raised(lambda: sop.solve_fAb_block(np.ones((n, 2)), k=4,
                                                 f="nope")),
        "k": _raised(lambda: sop.solve_fAb_block(np.ones((n, 2)), k=0)),
        "width": _raised(lambda: sop.solve_fAb_block(np.ones((n, 0)), k=4)),
        "complex": _raised(lambda: sop.solve_fAb_block(
            np.ones((n, 2), np.complex128), k=4)),
    }


def case_sparse_reorth(device, spec, b, k, reorth, f="inv"):
    """``solve_fAb(..., method="one_pass", reorth=...)`` and the basis
    of this rank's rows (its orthogonality defect over the mesh)."""
    import torch
    from two_pass_lanczos_tpu_torch.solvers import pass_one_reorth
    sop = _sparse(device, spec)
    x, dec = sop.solve_fAb(b, k=k, f=f, method="one_pass", reorth=reorth)
    _, basis = pass_one_reorth(sop._matvec, sop._prepare_b(b), k,
                               "full" if reorth is True else reorth,
                               dot=sop._dot, reduce=sop._fold)
    s = dec.steps()
    v = basis[:s].to(torch.complex128 if basis.is_complex()
                     else torch.float64)
    gram = sop._fold(v.conj() @ v.T)
    defect = float((gram - torch.eye(s, dtype=gram.dtype)).abs().max())
    return dict(_dec(dec), x=x, defect=defect)


def case_sparse_dtype_errors(device, n):
    """What the constructor says to each dtype of the values (None: it
    takes them)."""
    from two_pass_lanczos_tpu_torch.parallel import ShardedSparseOperator
    mesh = _mesh(device)
    idx = np.arange(n)
    return {name: _raised(lambda: ShardedSparseOperator(
                n, idx, idx, np.ones(n, name), mesh))
            for name in ("complex64", "complex128", "float16", "int64")}


def case_sparse_reorth_errors(device, spec):
    sop = _sparse(device, spec)
    b = np.ones(sop.shape[0])
    return {
        "two_pass": _raised(lambda: sop.solve_fAb(
            b, k=4, f="inv", method="two_pass", reorth=True)),
        "callback": _raised(lambda: sop.solve_fAb(
            b, k=4, f="inv", method="one_pass", reorth=True,
            callback=lambda *a: True)),
        "typo": _raised(lambda: sop.solve_fAb(
            b, k=4, f="inv", method="one_pass", reorth="selectve")),
    }


def case_sparse_convert(device, jax_like, b, k):
    """``convert.sharded_operator_from_jax`` on the host fields of a JAX
    ``ShardedSparseOperator`` (its partition and local blocks as NumPy):
    a solve on the operator read back from them."""
    from two_pass_lanczos_tpu_torch.convert import sharded_operator_from_jax
    sop = sharded_operator_from_jax(jax_like, _mesh(device))
    x, dec = sop.solve_fAb(b, k=k, f="inv")
    return dict(_dec(dec), x=x)


def case_fused_slq(device, d, u, v, p, k, num_probes, key, f="exp"):
    """The arc-sharded SLQ, its probes, and a solve's pass one on the
    first probe (bitwise the SLQ row)."""
    import torch
    from two_pass_lanczos_tpu_torch import slq
    s = _f32(device, d, u, v, p)
    res = s.slq_trace(f, k=k, num_probes=num_probes, key=key)
    probes = slq._draw_probes(key, num_probes, s.n, torch.float32,
                              "rademacher")
    dec = s._slq_pass_one(probes, k)
    solo = s.pass_one(probes[0], k)
    return {"samples": _np(res.samples), "probes": _np(probes),
            "dec": _dec_stack(dec), "solo": _dec(solo)}


def case_fused_slq_errors(device, d, u, v, p):
    s = _f32(device, d, u, v, p)
    return {"num_probes": _raised(lambda: s.slq_trace(
                "inv", num_probes=0, key=0)),
            "f": _raised(lambda: s.slq_trace("bogus", key=0))}


def case_fused_dos(device, d, u, v, p, grid, k, num_probes, key):
    s = _f32(device, d, u, v, p)
    return {"phi": _np(s.slq_spectral_density(grid, k=k,
                                              num_probes=num_probes,
                                              key=key))}


def case_fused_adaptive(device, d, u, v, p, k, batch, target, max_probes,
                        key):
    s = _f32(device, d, u, v, p)
    res = s.slq_trace_adaptive(lambda t: t * t, k=k, batch=batch,
                               target_rel_stderr=target,
                               max_probes=max_probes, key=key)
    return {"estimate": float(res.estimate), "m": int(res.samples.shape[0])}


def case_fused_chebyshev(device, d, u, v, p, x, f, degree, interval=None,
                         raw=False):
    s = _f32(device, d, u, v, p)
    out = {}
    if interval is None:
        iv = s.estimate_interval()
        out["interval"] = iv
        out["cached"] = s.estimate_interval() is iv
    y = s.chebyshev_fAb(x, f, degree=degree, interval=interval, raw=raw)
    out["y"] = ({"ya": _np(y[0]), "yn": _np(y[1]), "m_d": s.m_d}
                if raw else y)
    return out


def case_fused_chebyshev_errors(device, d, u, v, p):
    s = _f32(device, d, u, v, p)
    return {"inv": _raised(lambda: s.chebyshev_fAb(
        np.ones(s.n, np.float32), "inv", interval=(-1.0, 1.0)))}


def case_sparse_card_path(device, d, u, v, p, b, k):
    """On a card: the f32 row-sharded solve launches K15 (the fixed-order
    CSR SpMV) for its owned part a matvec, and for its remote part where
    the rank has one, and nothing else; gathers once a matvec, replays
    bitwise, and agrees with the generic single-device solve."""
    import torch
    from two_pass_lanczos_tpu_torch import (
        SparseOperator,
        lanczos_pass_one,
        solve_fAb,
    )
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        record_collectives,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays
    spec = {"kkt": (d, u, v, p), "dtype": np.float32}
    sop = _sparse(device, spec)
    bt = torch.from_numpy(b).to(sop.device)
    reset_launches()
    with record_collectives() as log:
        x, dec = sop.solve_fAb(bt, k=k, f="inv")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                       num_arcs=len(d))
    op = SparseOperator(kkt_sorted_coo(arrays, dtype=np.float32,
                                       device=sop.device))
    x1 = solve_fAb(op, bt, k=k, f="inv")
    dec1 = lanczos_pass_one(op, bt, k)
    rep = case_sparse_replay(device, spec, b, k)
    return {"launches": launches, "x": x, "x1": _np(x1),
            "dec": _dec(dec), "dec1": _dec(dec1), "replay": rep["replay"],
            "starts": sum(1 for e in log.events if e == "all-gather-start"),
            "remote_nnz": sop.remote.nnz}


# --- the two-pass solve's CUDA graphs, its x gather, spans and counts ------

def _counted(fn):
    """``fn()``'s result, and what it added to ``LAUNCHES``, to the fused
    step's ``STEP_KERNELS``, to ``comm.COLLECTIVES`` and to an open
    ``record_collectives`` log."""
    import torch
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES
    from two_pass_lanczos_tpu_torch.parallel.comm import COLLECTIVES
    from two_pass_lanczos_tpu_torch.parallel.fused_sharded import (
        STEP_KERNELS,
    )
    from two_pass_lanczos_tpu_torch.utils.collectives import (
        record_collectives,
    )
    launches, collectives = dict(LAUNCHES), dict(COLLECTIVES)
    step_kernels = dict(STEP_KERNELS)
    with record_collectives() as log:
        out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {
        "launches": {k: LAUNCHES[k] - launches[k] for k in LAUNCHES
                     if LAUNCHES[k] != launches[k]},
        "step_kernels": {k: STEP_KERNELS[k] - step_kernels[k]
                         for k in STEP_KERNELS},
        "collectives": {k: COLLECTIVES[k] - collectives[k]
                        for k in COLLECTIVES},
        "calls": list(log.calls), "events": list(log.events)}


def _gathered(s, b, k, f="inv"):
    """One raw solve and its x gathered on the device: NumPy x and the
    decomposition."""
    xr, dec = s.solve(b, k=k, f=f, raw=True)
    return dict(_dec(dec), x=_np(s.gather_x(xr)))


def case_gathered_solves(device, d, u, v, p, k, bs):
    """The raw solve of each b of ``bs`` (key → b) and its x gathered on
    the device (:meth:`gather_x`), as a benchmark call makes them."""
    s = _f32(device, d, u, v, p)
    return {key: _gathered(s, b, k) for key, b in bs.items()}


def case_gather_x(device, d, u, v, p, b, k, nf):
    """``gather_x`` of the raw pair and of the local x, against
    ``unpack`` and the solve's own NumPy x, for one f or ``nf`` of them."""
    import torch
    s = _f32(device, d, u, v, p)
    f = "inv" if nf == 0 else ("inv",) * nf
    (xa, xn), _ = s.solve(b, k=k, f=f, raw=True)
    pair = _np(s.gather_x((xa, xn)))
    local = torch.cat([xa, xn], dim=-1)
    x_np, _ = s.solve(b, k=k, f=f)
    return {"pair": pair, "local": _np(s.gather_x(local)),
            "unpack": s.unpack(local), "solve": x_np,
            "device": str(s.gather_x(local).device)}


def case_spans(device, d, u, v, p, b, k):
    """The ``tpl.*`` spans of a two-pass solve, raw with its gather, a
    one-pass and a callback solve: ``[(name, parent)]`` each, as
    ``tests/test_torch_spans.py`` reads them."""
    from torch.profiler import ProfilerActivity, profile
    s = _f32(device, d, u, v, p)

    def spans(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        out = []
        for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
            if not ev.name.startswith("tpl."):
                continue
            up = ev.cpu_parent
            while up is not None and not up.name.startswith("tpl."):
                up = up.cpu_parent
            out.append((ev.name, None if up is None else up.name))
        return out

    return {
        "two_pass": spans(lambda: s.solve(b, k=k)),
        "raw": spans(lambda: s.gather_x(s.solve(b, k=k, raw=True)[0])),
        "one_pass": spans(lambda: s.solve(b, k=k, method="one_pass",
                                          raw=True)),
        "callback": spans(lambda: s.solve(
            b, k=k, raw=True, callback=lambda *_: True, callback_chunk=5)),
    }


def case_counts(device, d, u, v, p, b, k):
    """What a solve with its x gather adds to the counters and the log:
    ``solve`` itself, and a raw solve then :meth:`gather_x`."""
    s = _f32(device, d, u, v, p)
    _, whole = _counted(lambda: s.solve(b, k=k))
    _, raw = _counted(lambda: s.gather_x(s.solve(b, k=k, raw=True)[0]))
    return {"whole": whole, "raw": raw, "m_d": s.m_d, "p": s.p,
            "width": max(s.shard_sizes), "world": s.mesh.size}


def case_graph_path(device, d, u, v, p, b, b2, k, k2):
    """On a card: a solver's first solve (eager), its second (captured,
    then replayed), a second b through the same graphs and a new k,
    against eager solves of the same b on fresh solvers; with what each
    solve counted."""
    s = _f32(device, d, u, v, p)
    first, eager_counts = _counted(lambda: _gathered(s, b, k))
    again, captured_counts = _counted(lambda: _gathered(s, b, k))
    after_capture = len(s._graphs)
    again2, replay_counts = _counted(lambda: _gathered(s, b2, k))
    other_k, _ = _counted(lambda: _gathered(s, b, k2))
    eager2 = _gathered(_f32(device, d, u, v, p), b2, k)
    eager_k2 = _gathered(_f32(device, d, u, v, p), b, k2)
    return {"first": first, "again": again, "again2": again2,
            "eager2": eager2, "other_k": other_k, "eager_k2": eager_k2,
            "graphs": (after_capture, len(s._graphs), sorted(s._graphs)),
            "counts": (eager_counts, captured_counts, replay_counts)}


def case_fused_step(device, d, u, v, p, b, k, chunk, breakdown):
    """The arc-sharded solver's passes as the fused step runs them on a card
    (the core scans on the CPU): a solve (eager) and the same solve again
    (replayed), a solve of two functions, pass one chunked and whole, the
    basis pass and pass two of y = I (which gives the basis back), a zero
    b, the breakdown instance ``breakdown`` = (d, u, v, p, b) solved twice,
    and one card's ``FusedKKTSolver`` on the same b."""
    import torch
    from two_pass_lanczos_tpu_torch import FusedKKTSolver
    s = _f32(device, d, u, v, p)
    first = _gathered(s, b, k)
    out = {"first": first, "again": _gathered(s, b, k),
           "nf2": _gathered(s, b, k, f=("inv", "exp"))}
    whole = s.pass_one(b, k)
    chunked, _ = s.pass_one_chunked(b, k, chunk=chunk)
    out["chunked"] = (_dec(chunked), _dec(whole))
    dec, basis = s.pass_one_with_basis(b, k)
    rows = s.pass_two(b, dec, torch.eye(k, device=s.device))
    out["replay"] = (torch.equal(rows, basis),
                     torch.equal(dec.alphas, whole.alphas)
                     and torch.equal(dec.betas, whole.betas))
    out["zero"] = _gathered(s, np.zeros_like(b), k)
    sb = _f32(device, *breakdown[:4])
    out["breakdown"] = (_gathered(sb, breakdown[4], k),
                        _gathered(sb, breakdown[4], k))
    x1, dec1 = FusedKKTSolver(d, u, v, p, device=s.device).solve(
        torch.from_numpy(b).to(s.device), k=k, f="inv")
    out["one_card"] = dict(_dec(dec1), x=_np(x1))
    return out


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def _main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, job_path, out = argv[3], argv[4], Path(argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from two_pass_lanczos_tpu_torch.parallel import initialize_distributed

    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    device = job["device"]
    initialize_distributed(f"file://{store}", world, rank, device=device)
    results = {}
    for key, name, kwargs in job["cases"]:
        results[key] = CASES[name](device, **kwargs)
    dist.barrier()
    dist.destroy_process_group()
    assert "jax" not in sys.modules, "a rank imported jax"
    with open(out / f"rank{rank}.out.pkl", "wb") as fh:
        pickle.dump(results, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv))
