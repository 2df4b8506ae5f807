#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Usage, from the root of a checkout::

    python3 chip_smoke.py

Phases (each one raises on failure, so the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the port's CUDA kernels from ``two_pass_lanczos_tpu_torch/csrc``;
3. K1, the KKT matvec, against its plain PyTorch version on the headline
   instance ``generate_mcf_instance(500_000, rho=3, instance_id=1)``
   (m = 500,000 arcs, p = 1,155 nodes, n = 501,155);
4. K2, pass one, against the plain ``pass_one_scan`` at k = 20;
5. K3, pass two, against the plain ``pass_two_scan`` on K2's decomposition;
6. the main path ``FusedKKTSolver.solve(b, k=500, f="inv")`` with ``b`` on
   the card, with the launch counters reset just before it: every kernel
   must have launched, x must be finite, pass two must regenerate pass
   one's v_s bit for bit, and a small instance must agree with the CPU f64
   oracle;
7. wall times of k = 500 and k = 1000 solves, of the one-pass, callback
   (never stopping, chunk 64) and compensated solves at k = 500, and of
   each kernel, beside the plain PyTorch versions on the same card;
8. K4, pass one with the basis: alpha, beta and steps bitwise K2's at
   k = 500, basis row s-1 bitwise pass one's and pass two's v_s, the basis
   within 1e-5 of the plain ``pass_one_scan(emit_basis=True)`` at k = 20,
   rows past a breakdown zero, and the main path
   ``solve(b, 500, method="one_pass")`` within rel 1e-4 of the two-pass x;
9. K5, the resumable pass one: ``pass_one_chunked(b, 500, chunk=64)``
   bitwise K2's, a callback stop at s = 100 after at most 128 matvecs with
   K2's alpha prefix, agreement with the plain ``pass_one_chunk_scan`` at
   k = 20, chunk 8, and the main path ``solve(b, 500, callback=...)``;
10. K6, the compensated builds: within rtol 1e-5 of the plain f64-dot pass
    one at k = 20 and at most 0.25x plain K2's distance from it, alpha
    strictly closer than plain K2's to the f64 oracle at k = 6 on the
    instance of the JAX package's test (m = 1200, p = 300), chunked and
    one-pass bitwise the
    monolithic run at k = 500, and the main path
    ``FusedKKTSolver(..., compensated=True).solve(b, 500)``;
11. K13, the error-free transformations: exact values on the card;
12. K8, the matvec of the generic KKT operators (``make_kkt_operator``):
    the f32 instance against the plain ``kkt_matvec`` on the headline (arc
    part bitwise, node part within 2·deg·ε·Σ|x|), the f64 instance against
    the plain f64 matvec with the ε of f64, the operator that
    ``operator_from_jax``'s NumPy path builds giving the same y, and the
    time of a cuSPARSE CSR SpMV of the assembled A as the yardstick;
13. the generic two-pass path ``solve_fAb(op, b, k=500, f="inv")`` on the
    headline with the counters reset just before it: K8 launched exactly
    2k - 1 = 999 times and no plain matvec; x finite; the basis that
    ``lanczos_pass_two_with_basis`` regenerates bitwise
    ``lanczos_standard``'s at k = 500; ``solve_fAb``'s x and the host
    path's (``lanczos_two_pass``) x bitwise pass two of their own y (the
    f32 solve of T_500 e₁ on the card and on the host), each y within
    10·κ(T)·ε of the f64 solve of the same α, β, and the gap between the
    two x within ‖V‖₂·‖Δy‖ plus pass two's f32 rounding; α, β at k = 20
    within rtol 1e-4 of the fused K2; a small instance against the CPU f64
    oracle; the launches of ``lanczos_two_pass`` and of ``lanczos``
    (one-pass, a 1.0 GB basis) counted;
14. f64 and the other operators on the card: ``lanczos_two_pass`` on a
    ``DiagonalOperator`` against the analytic x ({inv, exp, z²} at 1e-3 /
    1e-12), the two-pass basis bitwise on an f64 KKT of m = 200,000, and a
    ``SparseOperator`` (``kkt_sorted_coo``) whose pass two regenerates pass
    one's basis bitwise; then the medians of 5 generic two-pass and one-pass
    k = 500 solves and K8's time beside the plain version's and cuSPARSE's;
15. K11, the double-float matvec (``DFKKTOperator``), on the headline with
    f64 costs: arc part bitwise its plain version in both planes, node part
    within 8·(deg+1)·2⁻⁴⁸·Σ|x|, rel 1e-13 of K8's f64 instance, and its
    time beside the plain version's and a cuSPARSE f64 CSR SpMV's;
16. K9 and K10, the double-float passes, and the df main path
    ``DFFusedKKTSolver(d64, u, v, p).solve(b64, k=500, f="inv")`` with b on
    the card and the counters reset: K9 and K10 once each with 2k - 1 = 999
    K11 launches inside them and no plain df op; x finite; pass two's hi
    and lo v_s bitwise pass one's; α, β at k = 20 within 1e-11·max|α| of
    the f64 generic pass one (K8 f64) and of the plain df pass one; a
    small instance against the CPU f64 oracle; max|Δα| against the f64
    run at k = 100/200/500; the median of 5 df solves.

Every kernel's entry of the JSON line carries its launches on its main
path, its max_abs_err against its plain version, its time (``ms``), the
plain version's (``plain_ms``), ``bound_ms`` (the larger of the bytes the
function must move, each input read once and each output written once,
over 3.35 TB/s and its f32 operations (a double-float operation counted as
the f32 operations it is made of) over 67 TFLOP/s, the H100 SXM's
peaks, counted from this run's shapes and steps; ``bound_by`` names the
larger) and ``library_ms``, the time of one PyTorch call that computes the
same function (cuSPARSE SpMV for the matvecs), or null. A single call
(K1, K8, K13, their plain versions, cuSPARSE) is timed as device time:
200 calls captured in one CUDA graph and replayed, so the host's launch
cost is not in it. A pass (K2-K6 and their plain
versions) is timed by CUDA events around the whole pass, idle gaps
between its launches included.

The line before the last is that JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it prints no result and exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = {"arcs": 500_000, "rho": 3, "instance_id": 1}
K = 500
K_LONG = 1000
K_CHECK = 20
CHUNK = 64
STOP_AT = 100
M_F64 = 200_000  # arcs of phase 14's f64 KKT
K_F64 = 100
#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s and f32 FLOP/s
#: outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
PASS_ONE_CU = "two_pass_lanczos_tpu_torch/csrc/lanczos_pass_one.cu"
KERNELS = {
    "kkt_matvec": ("two_pass_lanczos_tpu_torch/csrc/kkt_matvec.cu",
                   "two_pass_lanczos_tpu/ops/kkt_fused.py:924"),
    "lanczos_pass_one": (PASS_ONE_CU,
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:581"),
    "lanczos_pass_two": ("two_pass_lanczos_tpu_torch/csrc/lanczos_pass_two.cu",
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:841"),
    "lanczos_pass_one_basis": (PASS_ONE_CU,
                               "two_pass_lanczos_tpu/ops/kkt_fused.py:752"),
    "lanczos_pass_one_chunk": (PASS_ONE_CU,
                               "two_pass_lanczos_tpu/ops/kkt_fused.py:647"),
    "lanczos_pass_one_comp": (PASS_ONE_CU,
                              "two_pass_lanczos_tpu/ops/kkt_fused.py:567"),
    "eft_check": ("two_pass_lanczos_tpu_torch/csrc/eft_check.cu",
                  "tests/test_fused_df.py:274"),
    "kkt_operator_matvec": ("two_pass_lanczos_tpu_torch/csrc/kkt_matvec.cu",
                            "two_pass_lanczos_tpu/ops/spmv_pallas.py:52"),
    "df_kkt_matvec": ("two_pass_lanczos_tpu_torch/csrc/df_kkt_matvec.cu",
                      "two_pass_lanczos_tpu/ops/kkt_fused_df.py:673"),
    "df_lanczos_pass_one": (
        "two_pass_lanczos_tpu_torch/csrc/df_lanczos_pass_one.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused_df.py:381"),
    "df_lanczos_pass_two": (
        "two_pass_lanczos_tpu_torch/csrc/df_lanczos_pass_two.cu",
        "two_pass_lanczos_tpu/ops/kkt_fused_df.py:486"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls,
    after one warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, its replay timed by CUDA events, over ``reps``. The
    host's launch cost is not in it; the graph's gaps between kernels
    are."""
    import torch
    side = torch.cuda.Stream()  # warm up off the default stream, then capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = event_ms(graph.replay, 3) / reps
    del graph
    return ms


def roofline_ms(nbytes: float, flops: float):
    """(ms, what binds): the larger of bytes over the HBM rate and f32
    operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(m: int, n: int, steps: int, k: int) -> dict:
    """``(bound ms, what binds)`` of each kernel's function on an instance
    of m arcs and n = m + p unknowns, for passes of ``steps`` steps with
    k-long coefficient arrays.

    Bytes: each input read once and each output written once (f32 values,
    int32 indices); what a kernel reads again (the node-sorted incidence
    CSR that its layout builds from u and v, a pass's per-step state)
    belongs to its design, not to the function. Operations: f32, per step
    one matvec (3 per arc row, 2 per incidence entry) and the recurrence's
    vector work. The double-float kernels move (hi, lo) pairs, 8 bytes a
    value, and count the f32 operations of their error-free
    transformations (``csrc/df_common.cuh``: df_prod 6, df_add2 11,
    df_axpy 17, df_scale 9): a df matvec 28 per arc row and 11 per
    incidence entry, 50 per arc; a df pass-one step 76 per unknown (two
    axpys fused with a product and a fold, one scale), a pass-two step 60.
    """
    from two_pass_lanczos_tpu_torch.observability import df_kkt_matvec_bytes
    mv_in = 12 * m                   # d, u, v
    mv_flops = 5 * m
    p1_bytes = mv_in + 4 * n + 8 * k  # + b; alpha, beta out
    p1_flops = steps * (mv_flops + 9 * n)
    matvec = roofline_ms(mv_in + 8 * n, mv_flops)  # + x in, y out
    df_mv_flops = 50 * m
    # d, u, v, b pairs in; alpha, beta pairs and the ||b|| pair out
    df_p1_bytes = 16 * m + 8 * n + 16 * k + 8
    return {
        "kkt_matvec": matvec,
        "lanczos_pass_one": roofline_ms(p1_bytes, p1_flops),
        # + x out, y in
        "lanczos_pass_two": roofline_ms(p1_bytes + 4 * n + 4 * k,
                                        steps * (mv_flops + 7 * n)),
        # + the (steps, n) basis out
        "lanczos_pass_one_basis": roofline_ms(p1_bytes + 4 * steps * n,
                                              p1_flops),
        "lanczos_pass_one_chunk": roofline_ms(p1_bytes, p1_flops),
        "lanczos_pass_one_comp": roofline_ms(
            p1_bytes, steps * (mv_flops + 31 * n)),
        # (2, 128) in, (6, 128) out
        "eft_check": roofline_ms(32 * 128, 30 * 128),
        "kkt_operator_matvec": matvec,
        "df_kkt_matvec": roofline_ms(
            df_kkt_matvec_bytes(m, n - m), df_mv_flops),
        "df_lanczos_pass_one": roofline_ms(
            df_p1_bytes, steps * (df_mv_flops + 76 * n)),
        # + the x pair out, the y pair in
        "df_lanczos_pass_two": roofline_ms(
            df_p1_bytes + 8 * n + 8 * k, steps * (df_mv_flops + 60 * n)),
    }


def wall_s(fn, reps: int) -> list:
    """Host seconds of each of ``reps`` calls, each ending in a sync."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    if not (ROOT / "two_pass_lanczos_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: two_pass_lanczos_tpu_torch/ not found beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from two_pass_lanczos_tpu_torch import (
        FusedKKTSolver,
        generate_mcf_instance,
        padded_f_e1,
    )
    from two_pass_lanczos_tpu_torch.algorithms.core import (
        LanczosDecomposition,
        dot_f64,
        pass_one_chunk_scan,
        pass_one_last_vector,
        pass_one_scan,
        pass_two_scan,
    )
    from two_pass_lanczos_tpu_torch.ops import _build
    from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        eft_check_cuda,
        kkt_matvec_cuda,
        pass_one_basis_cuda,
        pass_one_cuda,
        pass_two_cuda,
        reset_launches,
    )
    from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("    " + line.strip())

    # the headline instance, on the card
    inst = generate_mcf_instance(**HEADLINE)
    t0 = time.perf_counter()
    solver = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                            inst.num_nodes, device=dev)
    lay = solver.layout
    n = solver.n
    print(f"    headline m={lay.m} p={lay.p} n={n}; layout build + upload "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    def plain_mv(x):
        return kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)

    # 3. K1 against the plain matvec
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    y = kkt_matvec_cuda(lay, x)
    y_ref = plain_mv(x)
    torch.cuda.synchronize()
    m = lay.m
    check(torch.equal(y[:m], y_ref[:m]),
          "K1 arc part differs from the plain version's rounding")
    # node sums in two orders: |diff| <= 2·deg·eps·Σ|terms| per node
    absum = torch.zeros(lay.p, device=dev)
    absum.index_add_(0, lay.u, x[:m].abs()).index_add_(0, lay.v, x[:m].abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).float()
    bound = 2 * deg * torch.finfo(torch.float32).eps * absum
    node_err = (y[m:] - y_ref[m:]).abs()
    check(bool((node_err <= bound).all()), "K1 node part outside 2·deg·eps·Σ|x|")
    check(torch.equal(kkt_matvec_cuda(lay, x), y), "K1 not bitwise reproducible")
    err_k1 = float((y - y_ref).abs().max())
    print(f"[3] K1 ok: arc part bitwise equal, node max|err| "
          f"{float(node_err.max()):.3e} (bound min "
          f"{float(bound[deg > 0].min()):.3e}), max_abs_err {err_k1:.3e}")

    # 4. K2 against the plain pass one, k = 20
    dec = pass_one_cuda(lay, b, K_CHECK, solver.tol, solver.ztol)
    ref, _ = pass_one_scan(plain_mv, b, K_CHECK)
    torch.cuda.synchronize()
    check(dec.steps() == ref.steps() == K_CHECK,
          f"K2 steps {dec.steps()} vs plain {ref.steps()}")
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(float(dec.b_norm), float(ref.b_norm), rtol=1e-6)
    err_k2 = max(float((dec.alphas - ref.alphas).abs().max()),
                 float((dec.betas - ref.betas).abs().max()))
    print(f"[4] K2 ok at k={K_CHECK}: alpha, beta within rtol 1e-4, "
          f"max_abs_err {err_k2:.3e}, |alpha| max "
          f"{float(ref.alphas.abs().max()):.3e}")

    # 5. K3 against the plain pass two on the same decomposition
    y20 = padded_f_e1(dec, "inv") * dec.b_norm
    x3 = pass_two_cuda(lay, b, dec, y20, solver.ztol)
    x3_ref, _ = pass_two_scan(plain_mv, b, dec, y20)
    torch.cuda.synchronize()
    rel3 = float(torch.linalg.norm(x3 - x3_ref) / torch.linalg.norm(x3_ref))
    check(rel3 < 1e-5, f"K3 rel {rel3:.3e} >= 1e-5")
    err_k3 = float((x3 - x3_ref).abs().max())
    print(f"[5] K3 ok: rel {rel3:.3e} < 1e-5, max_abs_err {err_k3:.3e}")

    # 6. the main path, through the kernels only
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_main, dec_main = solver.solve(b, k=K, f="inv", raw=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: LAUNCHES[name] for name in
                ("kkt_matvec", "lanczos_pass_one", "lanczos_pass_two")}
    check(all(launches.values()), f"launches {dict(LAUNCHES)}")
    check(tuple(x_main.shape) == (n,) and x_main.is_cuda, "x shape/device")
    check(bool(torch.isfinite(x_main).all()), "x is not finite")
    steps = dec_main.steps()
    print(f"[6] solve(k={K}, f='inv') first call {first_s:.4f} s, "
          f"steps_taken {steps}, launches {launches}")
    st1 = torch.empty(2, n, device=dev)
    st2 = torch.empty(2, n, device=dev)
    dec1 = solver.pass_one(b, K, state=st1)
    check(torch.equal(dec1.alphas, dec_main.alphas)
          and torch.equal(dec1.betas, dec_main.betas),
          "pass one not bitwise reproducible")
    keep = torch.arange(K, device=dev) < dec1.steps_taken
    y_full = torch.where(keep, padded_f_e1(dec1, "inv") * dec1.b_norm, 0.0)
    x_rep = solver.pass_two(b, dec1, y_full, state=st2)
    torch.cuda.synchronize()
    check(torch.equal(pass_one_last_vector(dec1, st1), st2[1]),
          f"pass two's v_{steps} differs from pass one's")
    resid = float(torch.linalg.norm(solver.matvec(x_main) - b)
                  / torch.linalg.norm(b))
    print(f"    bitwise replay ok: pass two's v_{steps} == pass one's "
          f"(n={n}); x repeat bitwise equal: {torch.equal(x_rep, x_main)}; "
          f"||Ax-b||/||b|| = {resid:.4e}")
    # small instance: the card's solve against the CPU f64 plain oracle
    srng = np.random.default_rng(42)
    sm_, sp = 700, 300
    su = srng.integers(0, sp, sm_).astype(np.int32)
    sv = ((su + 1 + srng.integers(0, sp - 1, sm_)) % sp).astype(np.int32)
    sd = srng.uniform(1.0, 3.0, sm_).astype(np.float32)
    sb = srng.standard_normal(sm_ + sp)
    xs, _ = FusedKKTSolver(sd, su, sv, sp, device=dev).solve(
        sb.astype(np.float32), k=25, f="inv")
    t64 = torch.from_numpy
    sdec, _ = pass_one_scan(
        lambda v: kkt_matvec(t64(sd.astype(np.float64)), t64(su), t64(sv), sp, v),
        t64(sb), 25)
    sy = padded_f_e1(sdec, "inv") * sdec.b_norm
    xs_ref, _ = pass_two_scan(
        lambda v: kkt_matvec(t64(sd.astype(np.float64)), t64(su), t64(sv), sp, v),
        t64(sb), sdec, sy)
    rel_small = float(np.linalg.norm(xs - xs_ref.numpy())
                      / np.linalg.norm(xs_ref.numpy()))
    check(rel_small < 1e-4, f"small-instance rel {rel_small:.3e} vs f64 oracle")
    print(f"    small instance (m=700, p=300, k=25) vs CPU f64 oracle: "
          f"rel {rel_small:.3e} < 1e-4")
    solver_c = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                              inst.num_nodes, device=dev, compensated=True)

    # 7. timings (the Lanczos state is L2-resident in a real pass, so the
    #    kernels are timed warm, back to back)
    def solve_k(k):
        return lambda: solver.solve(b, k=k, f="inv", raw=True)

    def plain_solve():
        d_, _ = pass_one_scan(plain_mv, b, K)
        yy = torch.where(torch.arange(K, device=dev) < d_.steps_taken,
                         padded_f_e1(d_, "inv") * d_.b_norm, 0.0)
        return pass_two_scan(plain_mv, b, d_, yy)

    def never_stop(s_, v_, t_):
        return True

    def plain_chunked(k, chunk):
        carry = None
        for j0 in range(0, k, chunk):
            _, _, carry = pass_one_chunk_scan(plain_mv, b, min(chunk, k - j0),
                                              carry, k)
            int(carry.steps)  # the per-chunk read back, as the solver does
        return carry

    ea = torch.full((128,), 1.0 + 2.0 ** -12, device=dev)
    eb = torch.full((128,), 2.0 ** -30, device=dev)
    t_plain1 = wall_s(plain_solve, 1)
    t500 = wall_s(solve_k(K), 5)
    t1000 = wall_s(solve_k(K_LONG), 3)
    t_one = wall_s(lambda: solver.solve(b, k=K, f="inv", method="one_pass",
                                        raw=True), 5)
    t_cb = wall_s(lambda: solver.solve(b, k=K, f="inv", raw=True,
                                       callback=never_stop,
                                       callback_chunk=CHUNK), 5)
    t_comp = wall_s(lambda: solver_c.solve(b, k=K, f="inv", raw=True), 5)
    t_plain2 = wall_s(plain_solve, 1)
    ms = {
        "kkt_matvec": device_ms(lambda: kkt_matvec_cuda(lay, x), 200),
        "lanczos_pass_one": event_ms(
            lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol), 3),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_cuda(lay, b, dec1, y_full, solver.ztol), 3),
        "lanczos_pass_one_basis": event_ms(
            lambda: pass_one_basis_cuda(lay, b, K, solver.tol, solver.ztol), 3),
        "lanczos_pass_one_chunk": event_ms(
            lambda: solver.pass_one_chunked(b, K, chunk=CHUNK), 3),
        "lanczos_pass_one_comp": event_ms(
            lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol,
                                  compensated=True), 3),
        "eft_check": device_ms(lambda: eft_check_cuda(ea, eb), 200),
    }
    plain_ms = {
        "kkt_matvec": device_ms(lambda: plain_mv(x), 200),
        "lanczos_pass_one": event_ms(lambda: pass_one_scan(plain_mv, b, K), 1),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_scan(plain_mv, b, dec1, y_full), 1),
        "lanczos_pass_one_basis": event_ms(
            lambda: pass_one_scan(plain_mv, b, K, emit_basis=True), 1),
        "lanczos_pass_one_chunk": event_ms(lambda: plain_chunked(K, CHUNK), 1),
        "lanczos_pass_one_comp": event_ms(
            lambda: pass_one_scan(plain_mv, b, K, dot=dot_f64), 1),
        "eft_check": device_ms(lambda: eft_check_plain(ea, eb), 200),
    }
    k1_call_ms = event_ms(lambda: kkt_matvec_cuda(lay, x), 200)

    def runs(ts):
        return (f"median {statistics.median(ts):.4f} s "
                f"(runs {', '.join(f'{t:.4f}' for t in ts)})")

    print(f"[7] on {card}:")
    print(f"    solve k={K}: {runs(t500)}")
    print(f"    solve k={K_LONG}: {runs(t1000)}")
    print(f"    one-pass solve k={K}: {runs(t_one)}")
    print(f"    callback solve k={K} (never stops, chunk {CHUNK}): "
          f"{runs(t_cb)}")
    print(f"    compensated two-pass solve k={K}: {runs(t_comp)}")
    print(f"    plain PyTorch solve k={K} on the card: "
          f"{', '.join(f'{t:.4f}' for t in t_plain1 + t_plain2)} s")
    for name in ms:
        print(f"    {name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms")
    print(f"    kkt_matvec per call from Python (CUDA events, 200 calls): "
          f"{k1_call_ms:.4f} ms")

    # 8. K4: pass one with the basis
    dec4, basis = solver.pass_one_with_basis(b, K)
    torch.cuda.synchronize()
    check(torch.equal(dec4.alphas, dec1.alphas)
          and torch.equal(dec4.betas, dec1.betas)
          and dec4.steps() == dec1.steps(), "K4 alpha/beta/steps differ from K2")
    check(torch.equal(basis[steps - 1], pass_one_last_vector(dec1, st1))
          and torch.equal(basis[steps - 1], st2[1]),
          f"K4 basis row {steps - 1} is not pass one's and pass two's v_{steps}")
    del basis
    dec4s, basis_s = solver.pass_one_with_basis(b, K_CHECK)
    ref4, basis_ref = pass_one_scan(plain_mv, b, K_CHECK, emit_basis=True)
    torch.cuda.synchronize()
    rel4 = float(torch.linalg.norm(basis_s - basis_ref)
                 / torch.linalg.norm(basis_ref))
    check(rel4 <= 1e-5, f"K4 basis rel {rel4:.3e} > 1e-5 at k={K_CHECK}")
    np.testing.assert_allclose(dec4s.alphas.cpu().numpy(),
                               ref4.alphas.cpu().numpy(), rtol=1e-4)
    err_k4 = max(float((basis_s - basis_ref).abs().max()),
                 float((dec4s.alphas - ref4.alphas).abs().max()),
                 float((dec4s.betas - ref4.betas).abs().max()))
    # a breakdown: all arcs share their endpoints, the Krylov space is tiny
    bm, bp = 130, 130
    bsolver = FusedKKTSolver(np.full(bm, 2.0, np.float32),
                             np.zeros(bm, np.int32), np.ones(bm, np.int32),
                             bp, device=dev)
    bb_ = torch.zeros(bm + bp, device=dev)
    bb_[0] = 1.0
    decb, basis_b = bsolver.pass_one_with_basis(bb_, 12)
    sb_ = decb.steps()
    check(0 < sb_ < 12 and bool((basis_b[sb_:] == 0).all())
          and bool(torch.isfinite(basis_b).all()),
          f"K4 rows past the breakdown at {sb_} are not zero")
    reset_launches()
    x_one, dec_one = solver.solve(b, k=K, f="inv", method="one_pass", raw=True)
    torch.cuda.synchronize()
    launches["lanczos_pass_one_basis"] = LAUNCHES["lanczos_pass_one_basis"]
    check(launches["lanczos_pass_one_basis"] > 0, f"launches {dict(LAUNCHES)}")
    rel_one = float(torch.linalg.norm(x_one - x_main)
                    / torch.linalg.norm(x_main))
    check(rel_one <= 1e-4, f"one-pass x rel {rel_one:.3e} > 1e-4 vs two-pass")
    # x = V_k·y stays full f32 when the caller allows TF32
    torch.backends.cuda.matmul.allow_tf32 = True
    x_tf32, _ = solver.solve(b, k=K, f="inv", method="one_pass", raw=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(x_tf32, x_one), "one-pass x changed under allow_tf32")
    print(f"[8] K4 ok: alpha, beta, steps bitwise K2's at k={K}; basis row "
          f"{steps - 1} bitwise v_{steps} of both passes; basis rel {rel4:.3e}"
          f" vs plain at k={K_CHECK}; rows past the breakdown at step {sb_}"
          f" zero; one-pass x vs two-pass x rel {rel_one:.3e}, bitwise the "
          f"same under allow_tf32; launches "
          f"{dict(LAUNCHES)}")

    # 9. K5: the resumable pass one
    dec5 = solver.pass_one_chunked(b, K, chunk=CHUNK)
    check(torch.equal(dec5.alphas, dec1.alphas)
          and torch.equal(dec5.betas, dec1.betas)
          and dec5.steps() == dec1.steps(), "K5 alpha/beta/steps differ from K2")
    reset_launches()
    dec_stop = solver.pass_one_chunked(
        b, K, callback=lambda s_, v_, t_: s_ < STOP_AT, chunk=CHUNK)
    stop_mv = LAUNCHES["kkt_matvec"]
    bound = -(-STOP_AT // CHUNK) * CHUNK
    check(dec_stop.steps() == STOP_AT, f"stopped at {dec_stop.steps()}")
    check(stop_mv <= bound, f"{stop_mv} pass-one matvecs > {bound}")
    check(torch.equal(dec_stop.alphas[:STOP_AT], dec1.alphas[:STOP_AT])
          and bool((dec_stop.alphas[STOP_AT:] == 0).all()),
          "K5 alpha prefix differs from K2's")
    dec5s = solver.pass_one_chunked(b, K_CHECK, chunk=8)
    carry = None
    a5, b5 = [], []
    for j0 in range(0, K_CHECK, 8):
        a_, b_, carry = pass_one_chunk_scan(plain_mv, b, 8, carry, K_CHECK)
        a5.append(a_[:K_CHECK - j0])
        b5.append(b_[:K_CHECK - j0])
    a5, b5 = torch.cat(a5), torch.cat(b5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(dec5s.alphas.cpu().numpy(), a5.cpu().numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(dec5s.betas.cpu().numpy(), b5.cpu().numpy(),
                               rtol=1e-4)
    err_k5 = max(float((dec5s.alphas - a5).abs().max()),
                 float((dec5s.betas - b5).abs().max()))
    reset_launches()
    x_cb, dec_cb = solver.solve(b, k=K, f="inv", raw=True,
                                callback=never_stop, callback_chunk=CHUNK)
    torch.cuda.synchronize()
    launches["lanczos_pass_one_chunk"] = LAUNCHES["lanczos_pass_one_chunk"]
    check(launches["lanczos_pass_one_chunk"] == -(-K // CHUNK),
          f"launches {dict(LAUNCHES)}")
    rel_cb = float(torch.linalg.norm(x_cb - x_main) / torch.linalg.norm(x_main))
    check(rel_cb <= 1e-6, f"callback solve x rel {rel_cb:.3e} vs two-pass")
    print(f"[9] K5 ok: chunk {CHUNK} bitwise K2 at k={K}; stop at "
          f"{STOP_AT} after {stop_mv} <= {bound} matvecs, alpha prefix "
          f"bitwise; rtol 1e-4 vs plain at k={K_CHECK}, chunk 8 (max_abs_err "
          f"{err_k5:.3e}); never-stopping callback solve x vs two-pass x "
          f"rel {rel_cb:.3e} (bitwise: {torch.equal(x_cb, x_main)}); "
          f"launches {dict(LAUNCHES)}")

    # 10. K6: the compensated builds
    reset_launches()
    sc = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                        inst.num_nodes, device=dev, compensated=True)
    x_c, dec_c = sc.solve(b, k=K, f="inv", raw=True)
    torch.cuda.synchronize()
    launches["lanczos_pass_one_comp"] = LAUNCHES["lanczos_pass_one_comp"]
    launches["eft_check"] = LAUNCHES["eft_check"]
    check(launches["lanczos_pass_one_comp"] > 0 and launches["eft_check"] > 0
          and LAUNCHES["lanczos_pass_one"] == 0, f"launches {dict(LAUNCHES)}")
    check(bool(torch.isfinite(x_c).all()), "compensated x is not finite")
    comp_launches = dict(LAUNCHES)
    dec6 = sc.pass_one(b, K_CHECK)
    ref6, _ = pass_one_scan(plain_mv, b, K_CHECK, dot=dot_f64)
    torch.cuda.synchronize()
    rtol6 = float(((dec6.alphas - ref6.alphas).abs()
                   / ref6.alphas.abs()).max())
    np.testing.assert_allclose(dec6.alphas.cpu().numpy(),
                               ref6.alphas.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(dec6.betas.cpu().numpy(),
                               ref6.betas.cpu().numpy(), rtol=1e-5)
    err_k6 = max(float((dec6.alphas - ref6.alphas).abs().max()),
                 float((dec6.betas - ref6.betas).abs().max()))
    # rtol 1e-5 alone would pass an uncompensated build (plain K2 sits ~2e-7
    # relative from the f64-dot version): the compensated kernel must sit
    # well inside plain K2's own distance from it, measured here
    err_k2_f64 = max(float((dec.alphas - ref6.alphas).abs().max()),
                     float((dec.betas - ref6.betas).abs().max()))
    check(err_k2_f64 > 0 and err_k6 <= 0.25 * err_k2_f64,
          f"compensated max_abs_err {err_k6:.3e} vs the f64-dot version is "
          f"not <= 0.25x plain K2's {err_k2_f64:.3e} at k={K_CHECK}")
    # the instance of tests/test_fused.py::test_compensated_alphas_closer_to_f64
    # (m=1200, p=300, seed 42): at k=6 the f32 vector updates, which no
    # reduction compensates, are of the same size as the dot errors, so
    # the comparison is instance-dependent; this one is the JAX test's
    k6 = 6
    crng = np.random.default_rng(42)
    cm, cp = 1200, 300
    cu = crng.integers(0, cp, cm).astype(np.int32)
    cv = ((cu + 1 + crng.integers(0, cp - 1, cm)) % cp).astype(np.int32)
    cd = crng.uniform(1.0, 3.0, cm).astype(np.float32)
    cb32 = crng.standard_normal(cm + cp).astype(np.float32)
    o64, _ = pass_one_scan(  # the CPU f64 oracle on the same f32 inputs
        lambda v: kkt_matvec(t64(cd.astype(np.float64)), t64(cu), t64(cv), cp, v),
        t64(cb32.astype(np.float64)), k6)
    a64 = o64.alphas.numpy()
    a_p = FusedKKTSolver(cd, cu, cv, cp, device=dev).pass_one(cb32, k6)
    a_c = FusedKKTSolver(cd, cu, cv, cp, device=dev,
                         compensated=True).pass_one(cb32, k6)
    err_p = float(np.abs(a_p.alphas.cpu().numpy().astype(np.float64) - a64).max())
    err_c = float(np.abs(a_c.alphas.cpu().numpy().astype(np.float64) - a64).max())
    check(err_c < err_p, f"compensated alpha err {err_c:.3e} not below "
          f"plain K2's {err_p:.3e}")
    dec_cc = sc.pass_one_chunked(b, K, chunk=CHUNK)
    dec_c1, basis_c = sc.pass_one_with_basis(b, K)
    torch.cuda.synchronize()
    for name, dd in (("chunked", dec_cc), ("one-pass", dec_c1)):
        check(torch.equal(dd.alphas, dec_c.alphas)
              and torch.equal(dd.betas, dec_c.betas),
              f"compensated {name} differs from compensated monolithic")
    del basis_c
    print(f"[10] K6 ok: launches {comp_launches}; rtol {rtol6:.3e} <= 1e-5 "
          f"vs plain f64-dot pass one at k={K_CHECK} (max_abs_err "
          f"{err_k6:.3e} <= 0.25x plain K2's {err_k2_f64:.3e}); m={cm}, "
          f"p={cp}, k={k6}: max|alpha - alpha_f64| compensated {err_c:.3e} "
          f"< plain K2 {err_p:.3e}; chunked and one-pass bitwise the "
          f"monolithic compensated run at k={K}")

    # 11. K13: the error-free transformations, exact on the card
    got = eft_check_cuda(ea, eb)
    exact = torch.tensor([1.0 + 2.0 ** -12, 2.0 ** -30, 1.0 + 2.0 ** -11,
                          2.0 ** -24, 1.0 + 2.0 ** -12, 2.0 ** -30],
                         device=dev)[:, None].expand(6, 128)
    torch.cuda.synchronize()
    check(torch.equal(got, exact), f"EFT values not exact: {got[:, 0]}")
    check(torch.equal(eft_check_plain(ea, eb), exact), "EFT twin not exact")
    err_k13 = float((got - exact).abs().max())
    print("[11] K13 ok: two_sum, two_prod, df_add2 exact on the card")

    # 12. K8: the generic KKT operators' matvec
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.convert import operator_from_jax
    from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.ops import spmv_kernel
    from two_pass_lanczos_tpu_torch.testing import (
        check_reconstruction_stability,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    arrays = KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                       arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                       num_arcs=inst.num_arcs)
    op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dtype=torch.float32)  # card, K8
    check(isinstance(op, tpl.CudaKKTOperator) and op.device.type == "cuda"
          and op.dtype == torch.float32, f"make_kkt_operator gave {op!r}")
    op64 = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                                 inst.num_nodes, dtype=torch.float64)
    lay8, lay64 = op.layout, op64.layout

    def node_bound(lay_, x_, eps):
        absum_ = torch.zeros(lay_.p, dtype=x_.dtype, device=dev)
        absum_.index_add_(0, lay_.u, x_[:m].abs())
        absum_.index_add_(0, lay_.v, x_[:m].abs())
        return 2 * (lay_.ptr[1:] - lay_.ptr[:-1]).to(x_.dtype) * eps * absum_

    y8 = op.matvec(x)
    y8_ref = kkt_matvec(lay8.d, lay8.u, lay8.v, lay8.p, x)
    torch.cuda.synchronize()
    check(torch.equal(y8, y), "K8 f32 differs from K1 on the same x")
    check(torch.equal(y8[:m], y8_ref[:m]), "K8 f32 arc part not bitwise")
    check(bool(((y8[m:] - y8_ref[m:]).abs()
                <= node_bound(lay8, x, torch.finfo(torch.float32).eps)).all()),
          "K8 f32 node part outside 2·deg·eps·Σ|x|")
    check(torch.equal(op.matvec(x), y8), "K8 f32 not bitwise reproducible")
    err_k8 = float((y8 - y8_ref).abs().max())
    x64 = x.double()
    y64 = op64.matvec(x64)
    y64_ref = kkt_matvec(lay64.d, lay64.u, lay64.v, lay64.p, x64)
    torch.cuda.synchronize()
    check(y64.dtype == torch.float64 and torch.equal(y64[:m], y64_ref[:m]),
          "K8 f64 arc part not bitwise")
    check(bool(((y64[m:] - y64_ref[m:]).abs()
                <= node_bound(lay64, x64,
                              torch.finfo(torch.float64).eps)).all()),
          "K8 f64 node part outside 2·deg·eps·Σ|x|")
    err_k8_64 = float((y64 - y64_ref).abs().max())

    # a PallasKKTOperator's fields, as operator_from_jax reads them (NumPy)
    pal = type("PallasKKTOperator", (), {})()
    m_pad = -(-m // 2048) * 2048  # the TPU kernel's padding, dropped again
    pal.d_pad = np.zeros(m_pad, np.float32)
    pal.d_pad[:m] = inst.quad_costs
    pal.u_pad = np.zeros(m_pad, np.int32)
    pal.u_pad[:m] = inst.arc_u
    pal.v_pad = np.zeros(m_pad, np.int32)
    pal.v_pad[:m] = inst.arc_v
    pal.num_arcs, pal.num_nodes = m, inst.num_nodes
    op_conv = operator_from_jax(pal)
    check(isinstance(op_conv, tpl.CudaKKTOperator)
          and torch.equal(op_conv.matvec(x), y8),
          "operator_from_jax's CudaKKTOperator differs from the KKT operator")
    coo32 = kkt_sorted_coo(arrays, dtype=np.float32)
    a_csr = torch.sparse_csr_tensor(coo32.indptr, coo32.cols, coo32.vals,
                                    size=(n, n))
    y_lib = torch.mv(a_csr, x)
    torch.cuda.synchronize()
    rel_lib = float(torch.linalg.norm(y_lib - y8) / torch.linalg.norm(y8))
    check(rel_lib < 1e-6, f"cuSPARSE SpMV rel {rel_lib:.3e} vs K8")
    print(f"[12] K8 ok: f32 bitwise K1 and arc part bitwise plain, node part "
          f"within bound, max_abs_err {err_k8:.3e}; f64 arc part bitwise, "
          f"node part within bound, max_abs_err {err_k8_64:.3e}; the "
          f"converted Pallas operator gives the same y; cuSPARSE CSR SpMV "
          f"(nnz {coo32.nnz}) rel {rel_lib:.3e}")

    # 13. the generic two-pass path on the headline, through K8 only
    plain_calls = []
    plain_mv_orig = spmv_kernel.kkt_matvec

    def counted_plain(*args):
        plain_calls.append(1)
        return plain_mv_orig(*args)

    spmv_kernel.kkt_matvec = counted_plain  # the operators' only plain route
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_gen = tpl.solve_fAb(op, b, k=K, f="inv")
    torch.cuda.synchronize()
    gen_first = time.perf_counter() - t0
    launches["kkt_operator_matvec"] = LAUNCHES["kkt_operator_matvec"]
    gen_launches = dict(LAUNCHES)
    check(LAUNCHES["kkt_operator_matvec"] == 2 * K - 1
          and sum(gen_launches.values()) == 2 * K - 1 and not plain_calls,
          f"generic launches {gen_launches}, plain calls {len(plain_calls)}")
    check(tuple(x_gen.shape) == (n,) and bool(torch.isfinite(x_gen).all()),
          "generic x not finite")
    reset_launches()
    x_host = tpl.lanczos_two_pass(op, b, K, tpl.make_inv_solver())
    torch.cuda.synchronize()
    host_launches = LAUNCHES["kkt_operator_matvec"]
    reset_launches()
    x_gen1 = tpl.lanczos(op, b, K, tpl.make_inv_solver())
    torch.cuda.synchronize()
    one_launches = LAUNCHES["kkt_operator_matvec"]
    spmv_kernel.kkt_matvec = plain_mv_orig
    check(host_launches == 2 * K - 1 and one_launches == K and not plain_calls,
          f"host path {host_launches}, one-pass {one_launches} launches")
    rel_host = float(torch.linalg.norm(x_host - x_gen)
                     / torch.linalg.norm(x_gen))
    rel_gen1 = float(torch.linalg.norm(x_gen1 - x_gen)
                     / torch.linalg.norm(x_gen))
    rel_fused = float(torch.linalg.norm(x_gen - x_main)
                      / torch.linalg.norm(x_main))
    dec_s, basis_s = tpl.lanczos_standard(op, b, K)
    steps_g = dec_s.steps()
    _, regen = tpl.lanczos_pass_two_with_basis(
        op, b, dec_s, torch.ones(K, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(regen[:steps_g], basis_s[:steps_g]),
          "generic pass two's basis differs from lanczos_standard's")
    del regen
    # x_gen and x_host are pass two over this one basis and differ only in
    # y = f(T_500)·e1·‖b‖, solved in f32 on the card (solve_fAb) and on the
    # host (make_inv_solver): hold each y to the f64 solve of the same α, β
    # and the x gap to what the y gap can make of it through the basis
    dec_p = tpl.lanczos_pass_one(op, b, K)
    check(steps_g == K and torch.equal(dec_p.alphas, dec_s.alphas)
          and torch.equal(dec_p.betas, dec_s.betas),
          "pass one's alpha, beta differ with and without the basis")
    y_gen = (padded_f_e1(dec_p, "inv") * dec_p.b_norm).to(b.dtype)
    al_, be_ = dec_p.alphas_valid(), dec_p.betas_valid()
    y_host = (torch.as_tensor(tpl.make_inv_solver()(al_, be_)).to(dev)
              * dec_p.b_norm)
    check(torch.equal(tpl.lanczos_pass_two(op, b, dec_p, y_gen), x_gen)
          and torch.equal(tpl.lanczos_pass_two(op, b, dec_p, y_host), x_host),
          "an x is not pass two of its own y")
    # the card's solve code is right: in f64 it gives the host's f64 answer
    # to within 10·κ(T)·ε64 ...
    bn_ = float(dec_p.b_norm)
    y_f64 = host_f_tk_solve(al_, be_, "inv") * bn_
    dec_p64 = LanczosDecomposition(
        alphas=dec_p.alphas.double(), betas=dec_p.betas.double(),
        steps_taken=dec_p.steps_taken, b_norm=dec_p.b_norm.double())
    y_card64 = (padded_f_e1(dec_p64, "inv") * dec_p64.b_norm).cpu().numpy()
    tk = np.diag(al_.astype(np.float64)) + np.diag(be_, 1) + np.diag(be_, -1)
    lam_t = np.abs(np.linalg.eigvalsh(tk))
    kappa = float(lam_t.max() / lam_t.min())
    eps32 = float(np.finfo(np.float32).eps)
    eps64 = float(np.finfo(np.float64).eps)
    rel_card64 = float(np.linalg.norm(y_card64 - y_f64) / np.linalg.norm(y_f64))
    check(rel_card64 <= 10 * kappa * eps64,
          f"padded_f_e1 in f64 on the card rel {rel_card64:.3e} from the "
          f"host's f64 solve, above 10·κ·ε64 = {10 * kappa * eps64:.3e}")
    # ... and each f32 y solves T y = ‖b‖e1 to a backward error of 10·ε32,
    # so its distance from the f64 answer is the f32 rounding of an
    # ill-conditioned solve
    tnorm = float(np.linalg.norm(tk, 2))
    rhs = np.zeros(K)
    rhs[0] = bn_
    back_y, rel_y = {}, {}
    for name, yy in (("card", y_gen), ("host", y_host)):
        y_ = yy.double().cpu().numpy()
        back_y[name] = float(np.linalg.norm(tk @ y_ - rhs)
                             / (tnorm * np.linalg.norm(y_)))
        rel_y[name] = float(np.linalg.norm(y_ - y_f64) / np.linalg.norm(y_f64))
    check(max(back_y.values()) <= 10 * eps32,
          f"f32 solves of T_{K} with backward errors {back_y} above 10·ε32")
    vd = basis_s.double()
    gram = vd @ vd.T
    v_norm = float(torch.linalg.eigvalsh(gram).max().sqrt())
    orth_loss = float((gram - torch.eye(K, dtype=gram.dtype, device=dev))
                      .abs().max())
    col = gram.diagonal().sqrt()
    del vd, gram, basis_s
    dy = float(torch.linalg.norm(y_gen.double() - y_host.double()))
    slack = (K + 1) * eps32 * float((y_gen.double().abs() * col).sum()
                                    + (y_host.double().abs() * col).sum())
    gap = float(torch.linalg.norm(x_gen.double() - x_host.double()))
    check(gap <= 1.001 * (v_norm * dy + slack),
          f"x gap {gap:.4e} above ‖V‖₂·‖Δy‖ + rounding = "
          f"{v_norm * dy:.4e} + {slack:.4e}")
    rel_alpha_fused = float((dec_main.alphas - dec_p.alphas).abs().max()
                            / dec_p.alphas.abs().max())
    dec_g = tpl.lanczos_pass_one(op, b, K_CHECK)
    np.testing.assert_allclose(dec_g.alphas.cpu().numpy(),
                               dec.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec_g.betas.cpu().numpy(),
                               dec.betas.cpu().numpy(), rtol=1e-4)
    sop = tpl.make_kkt_operator(sd, su, sv, sp)
    xs_gen = tpl.lanczos_two_pass(sop, sb.astype(np.float32), 25,
                                  tpl.make_inv_solver()).cpu().numpy()
    rel_small_gen = float(np.linalg.norm(xs_gen - xs_ref.numpy())
                          / np.linalg.norm(xs_ref.numpy()))
    check(rel_small_gen < 1e-4,
          f"generic small-instance rel {rel_small_gen:.3e} vs f64 oracle")
    print(f"[13] generic solve_fAb(k={K}, f='inv') first call "
          f"{gen_first:.4f} s, launches {gen_launches}, plain matvecs "
          f"{len(plain_calls)}; basis of lanczos_pass_two_with_basis bitwise "
          f"lanczos_standard's, rows 0..{steps_g - 1} (n={n}); alpha, beta "
          f"within rtol 1e-4 of K2 at k={K_CHECK}; x vs host path rel "
          f"{rel_host:.3e}, vs generic one-pass rel {rel_gen1:.3e}, vs the "
          f"fused solve rel {rel_fused:.3e}; lanczos_two_pass {host_launches}"
          f" and lanczos {one_launches} K8 launches; small instance vs CPU "
          f"f64 oracle rel {rel_small_gen:.3e}")
    print(f"     both x are pass two of their own y, bitwise; kappa(T_{K}) "
          f"{kappa:.4e}; padded_f_e1 in f64 on the card vs the host's f64 "
          f"solve rel {rel_card64:.3e} <= 10·kappa·eps64 "
          f"{10 * kappa * eps64:.3e}; f32 y backward error card "
          f"{back_y['card']:.3e}, host {back_y['host']:.3e} <= 10·eps32; "
          f"f32 y vs the f64 solve: card rel {rel_y['card']:.3e}, host rel "
          f"{rel_y['host']:.3e}; x gap {gap:.4e} <= "
          f"||V||_2 {v_norm:.4f} x ||dy|| {dy:.4e} + rounding {slack:.3e} "
          f"(gap / bound {gap / (v_norm * dy + slack):.4f}); "
          f"max|V V^T - I| {orth_loss:.3e}; fused vs generic alpha at k={K} "
          f"max rel {rel_alpha_fused:.3e}")

    # 14. f64 and the other operators on the card
    eigs = np.arange(1.0, 101.0)
    db = np.random.default_rng(12345).standard_normal(100)
    dop = tpl.DiagonalOperator(eigs)
    rel_diag = {}
    for name, solver, fx, tol in (
            ("inv", tpl.make_inv_solver(), 1.0 / eigs, 1e-3),
            ("exp", tpl.make_exp_solver(), np.exp(eigs), 1e-3),
            ("z2", tpl.make_poly_solver([0.0, 0.0, 1.0]), eigs ** 2, 1e-12)):
        xd_ = tpl.lanczos_two_pass(dop, db, 30, solver).cpu().numpy()
        rel_diag[name] = float(np.linalg.norm(xd_ - fx * db)
                               / np.linalg.norm(fx * db))
        check(rel_diag[name] < tol,
              f"f64 diagonal {name}: rel {rel_diag[name]:.3e} >= {tol}")
    frng = np.random.default_rng(42)
    fm, fp = M_F64, 2_000
    fu = frng.integers(0, fp, fm).astype(np.int32)
    fv = ((fu + 1 + frng.integers(0, fp - 1, fm)) % fp).astype(np.int32)
    fd = frng.uniform(1.0, 3.0, fm)
    fop = tpl.make_kkt_operator(fd, fu, fv, fp, dtype=torch.float64)
    fb = torch.from_numpy(frng.standard_normal(fm + fp)).to(dev)
    reset_launches()
    dec_f, basis_f = tpl.lanczos_standard(fop, fb, K_F64)
    _, regen_f = tpl.lanczos_pass_two_with_basis(
        fop, fb, dec_f, torch.ones(K_F64, dtype=torch.float64, device=dev))
    torch.cuda.synchronize()
    check(LAUNCHES["kkt_operator_matvec"] == 2 * K_F64 - 1,
          f"f64 launches {dict(LAUNCHES)}")
    check(torch.equal(regen_f, basis_f), "f64 KKT basis not replayed bitwise")
    del basis_f, regen_f
    small = KKTArrays(quad_costs=sd.astype(np.float64), arc_u=su, arc_v=sv,
                      num_nodes=sp, num_arcs=sm_)
    spop = tpl.SparseOperator(kkt_sorted_coo(small))
    sp_b = torch.from_numpy(sb).to(dev)
    drift = check_reconstruction_stability(spop, sp_b, 30).value
    check(drift == 0.0, f"SparseOperator basis drift {drift} != 0")
    check(torch.equal(spop.matvec(sp_b), spop.matvec(sp_b)),
          "SparseOperator matvec not reproducible")
    print(f"[14] f64 DiagonalOperator two-pass vs analytic: "
          + ", ".join(f"{k_} rel {v_:.3e}" for k_, v_ in rel_diag.items())
          + f"; f64 KKT m={fm}, p={fp}, k={K_F64}: basis bitwise; "
          f"SparseOperator (nnz {spop.mat.nnz}) drift {drift} at k=30")

    t_gen = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv"), 5)
    t_gen1 = wall_s(lambda: tpl.solve_fAb(op, b, k=K, f="inv",
                                          method="one_pass"), 5)
    t_host = wall_s(lambda: tpl.lanczos_two_pass(op, b, K,
                                                 tpl.make_inv_solver()), 3)
    ms["kkt_operator_matvec"] = device_ms(lambda: op.matvec(x), 200)
    plain_ms["kkt_operator_matvec"] = device_ms(lambda: plain_mv(x), 200)
    lib_ms = device_ms(lambda: torch.mv(a_csr, x), 200)
    ms_k8_64 = device_ms(lambda: op64.matvec(x64), 200)
    k8_call_ms = event_ms(lambda: op.matvec(x), 200)
    lib_call_ms = event_ms(lambda: torch.mv(a_csr, x), 200)
    print(f"    on {card}: generic two-pass solve_fAb k={K}: {runs(t_gen)}")
    print(f"    generic one-pass solve_fAb k={K}: {runs(t_gen1)}")
    print(f"    generic lanczos_two_pass (host path) k={K}: {runs(t_host)}")
    print(f"    kkt_operator_matvec device time: kernel "
          f"{ms['kkt_operator_matvec']:.5f} ms (f64 {ms_k8_64:.5f} ms), "
          f"plain {plain_ms['kkt_operator_matvec']:.5f} ms, cuSPARSE CSR "
          f"SpMV {lib_ms:.5f} ms; per call from Python (CUDA events): "
          f"kernel {k8_call_ms:.4f} ms, cuSPARSE {lib_call_ms:.4f} ms")

    # 15. K11: the double-float matvec on the headline, f64 costs
    from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, DFKKTOperator
    from two_pass_lanczos_tpu_torch.algorithms.df import lanczos_pass_one_df
    from two_pass_lanczos_tpu_torch.ops import kkt_fused_df
    from two_pass_lanczos_tpu_torch.ops.df import DF, df_from_f64
    from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
        df_kkt_matvec_cuda,
        df_pass_one_last_vector,
    )

    dfop = DFKKTOperator.from_f64(inst.quad_costs, inst.arc_u, inst.arc_v,
                                  inst.num_nodes, device=dev)
    check(torch.equal(dfop.d2[0], lay64.d.float())
          and bool((dfop.d2[1] != 0).any()),
          "the df costs are not the exact split of the f64 costs")
    dlay = dfop.layout
    xdf = df_from_f64(x64 * (1.0 + 1e-9 * x64))  # a lo plane that is not 0
    x2 = torch.stack([xdf.hi, xdf.lo])
    x_sp = x2[0].double() + x2[1].double()
    y2 = df_kkt_matvec_cuda(dlay, dfop.d2, x2)
    y2_ref = dfop.plain_matvec_df(xdf)
    torch.cuda.synchronize()
    check(torch.equal(y2[0, :m], y2_ref.hi[:m])
          and torch.equal(y2[1, :m], y2_ref.lo[:m]),
          "K11 arc part differs from the plain version's rounding")
    y_df = y2[0].double() + y2[1].double()
    y_df_ref = y2_ref.hi.double() + y2_ref.lo.double()
    # two compensated folds of a node sum: each df_add2 of partial sums a,
    # b errs by <= 3·2^-48·(|a| + |b|), a fold of deg terms adds deg such
    # errors, the plain version's final df_sub one more
    xa_abs = x_sp[:m].abs()
    absum_df = torch.zeros(dlay.p, dtype=torch.float64, device=dev)
    absum_df.index_add_(0, dlay.u, xa_abs).index_add_(0, dlay.v, xa_abs)
    deg_df = (dlay.ptr[1:] - dlay.ptr[:-1]).double()
    bound_df = 8 * (deg_df + 1) * 2.0 ** -48 * absum_df
    node_err_df = (y_df[m:] - y_df_ref[m:]).abs()
    check(bool((node_err_df <= bound_df).all()),
          "K11 node part outside 8·(deg+1)·2^-48·Σ|x|")
    check(torch.equal(df_kkt_matvec_cuda(dlay, dfop.d2, x2), y2),
          "K11 not bitwise reproducible")
    y_k8 = op64.matvec(x_sp)
    rel_k8 = float(torch.linalg.norm(y_df - y_k8) / torch.linalg.norm(y_k8))
    check(rel_k8 < 1e-13, f"K11 vs K8 f64 rel {rel_k8:.3e} >= 1e-13")
    err_k11 = float((y_df - y_df_ref).abs().max())
    coo64 = kkt_sorted_coo(arrays)
    a_csr64 = torch.sparse_csr_tensor(coo64.indptr, coo64.cols, coo64.vals,
                                      size=(n, n))
    rel_lib64 = float(torch.linalg.norm(torch.mv(a_csr64, x_sp) - y_k8)
                      / torch.linalg.norm(y_k8))
    check(rel_lib64 < 1e-13, f"cuSPARSE f64 SpMV rel {rel_lib64:.3e} vs K8")
    print(f"[15] K11 ok: arc part bitwise the plain version in hi and lo, "
          f"node part max|err| {float(node_err_df.max()):.3e} within "
          f"8·(deg+1)·2^-48·Σ|x| (min over nodes {float(bound_df.min()):.3e})"
          f", max_abs_err {err_k11:.3e}; vs K8 f64 rel {rel_k8:.3e}; "
          f"cuSPARSE f64 CSR SpMV rel {rel_lib64:.3e}")

    # 16. K9 and K10: the df main path, through the kernels only
    plain_df = []
    patched = [(DFKKTOperator, "plain_matvec_df"),
               (kkt_fused_df, "_pass_one_df"), (kkt_fused_df, "_pass_two_df")]
    originals = [getattr(o, a) for o, a in patched]

    def counted_df(fn):
        def wrapper(*args, **kw):
            plain_df.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper

    sdf = DFFusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, device=dev)
    b64 = b.double()
    for (o, a), fn in zip(patched, originals):
        setattr(o, a, counted_df(fn))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_df, (al_df, be_df, steps_df) = sdf.solve(b64, k=K, f="inv")
    torch.cuda.synchronize()
    df_first = time.perf_counter() - t0
    df_launches = dict(LAUNCHES)
    for (o, a), fn in zip(patched, originals):
        setattr(o, a, fn)
    for name in ("df_kkt_matvec", "df_lanczos_pass_one",
                 "df_lanczos_pass_two"):
        launches[name] = df_launches[name]
    check(df_launches["df_lanczos_pass_one"] == 1
          and df_launches["df_lanczos_pass_two"] == 1
          and df_launches["df_kkt_matvec"] == 2 * K - 1
          and sum(df_launches.values()) == 2 * K + 1 and not plain_df,
          f"df launches {df_launches}, plain df calls {plain_df}")
    check(tuple(x_df.shape) == (n,) and x_df.dtype == torch.float64
          and x_df.is_cuda and bool(torch.isfinite(x_df).all()),
          "df x not a finite f64 (n,) tensor on the card")
    b2 = sdf.pack(b64)
    st1 = torch.empty(2, 2, n, device=dev)
    st2 = torch.empty(2, 2, n, device=dev)
    coeffs = sdf.pass_one(b2, K, state=st1)
    a_rep = (coeffs[0].double() + coeffs[1].double()).cpu().numpy()
    check(int(coeffs[5][0]) == steps_df
          and np.array_equal(a_rep[:steps_df], al_df),
          "df pass one not bitwise reproducible")
    bn_df = float(coeffs[4][0].double() + coeffs[4][1].double())
    y_solve = np.zeros(K)
    y_solve[:steps_df] = host_f_tk_solve(al_df, be_df, "inv") * bn_df
    y_h32 = y_solve.astype(np.float32)
    y_h = torch.from_numpy(y_h32).to(dev)
    y_l = torch.from_numpy((y_solve - y_h32).astype(np.float32)).to(dev)
    x2_rep = sdf.pass_two(b2, coeffs, y_h, y_l, state=st2)
    torch.cuda.synchronize()
    check(torch.equal(df_pass_one_last_vector(coeffs, st1), st2[1]),
          f"df pass two's v_{steps_df} differs from pass one's (hi or lo)")
    check(torch.equal(sdf.unpack64(x2_rep), x_df), "df x not reproducible")
    # k = 20 against the f64 generic pass one (K8 f64) and the plain df one
    dec64_20 = tpl.lanczos_pass_one(op64, b64, K_CHECK)
    c20 = sdf.pass_one(b2, K_CHECK)
    a20 = (c20[0].double() + c20[1].double()).cpu().numpy()
    b20 = (c20[2].double() + c20[3].double()).cpu().numpy()
    atol20 = 1e-11 * float(dec64_20.alphas.abs().max())
    da64 = float(np.abs(a20 - dec64_20.alphas.cpu().numpy()).max())
    db64 = float(np.abs(b20[:K_CHECK - 1]
                        - dec64_20.betas.cpu().numpy()[:K_CHECK - 1]).max())
    check(int(c20[5][0]) == K_CHECK and max(da64, db64) <= atol20,
          f"df alpha/beta at k={K_CHECK} {da64:.3e}/{db64:.3e} from f64, "
          f"above 1e-11·max|alpha| = {atol20:.3e}")
    ref20 = lanczos_pass_one_df(dfop, b64, K_CHECK)
    ra20 = (ref20.alphas.hi.double() + ref20.alphas.lo.double()).cpu().numpy()
    rb20 = (ref20.betas.hi.double() + ref20.betas.lo.double()).cpu().numpy()
    err_k9 = max(float(np.abs(a20 - ra20).max()),
                 float(np.abs(b20 - rb20).max()))
    check(err_k9 <= atol20, f"K9 vs plain df pass one {err_k9:.3e} > "
          f"{atol20:.3e} at k={K_CHECK}")
    y20 = host_f_tk_solve(a20, b20[:K_CHECK - 1], "inv") * float(
        c20[4][0].double() + c20[4][1].double())
    y20h = torch.from_numpy(y20.astype(np.float32)).to(dev)
    y20l = torch.from_numpy((y20 - y20.astype(np.float32).astype(np.float64))
                            .astype(np.float32)).to(dev)
    x20 = sdf.unpack64(sdf.pass_two(b2, c20, y20h, y20l))
    dec20 = kkt_fused_df.DFDecomposition(
        alphas=DF(c20[0], c20[1]), betas=DF(c20[2], c20[3]),
        steps_taken=c20[5].reshape(()), b_norm=DF(c20[4][0], c20[4][1]))
    x20_ref, _, _ = kkt_fused_df._pass_two_df(
        dfop, DF(b2[0], b2[1]), dec20, DF(y20h, y20l), False)
    x20_ref = x20_ref.hi.double() + x20_ref.lo.double()
    rel_k10 = float(torch.linalg.norm(x20 - x20_ref)
                    / torch.linalg.norm(x20_ref))
    check(rel_k10 < 1e-12, f"K10 vs plain df pass two rel {rel_k10:.3e}")
    err_k10 = float((x20 - x20_ref).abs().max())
    # the small instance against the CPU f64 oracle
    xs_df, _ = DFFusedKKTSolver(sd.astype(np.float64), su, sv, sp,
                                device=dev).solve(sb, k=25, f="inv")
    rel_small_df = float(np.linalg.norm(xs_df.cpu().numpy() - xs_ref.numpy())
                         / np.linalg.norm(xs_ref.numpy()))
    check(rel_small_df < 1e-9,
          f"df small-instance rel {rel_small_df:.3e} vs f64 oracle")
    # how far df and f32 drift from an f64 run over the headline's steps
    a64_k = tpl.lanczos_pass_one(op64, b64, K).alphas.cpu().numpy()
    a32_k = dec1.alphas.double().cpu().numpy()
    drift = {kk: (float(np.abs(al_df[:kk] - a64_k[:kk]).max()),
                  float(np.abs(a32_k[:kk] - a64_k[:kk]).max()))
             for kk in (100, 200, K)}
    scale_a = float(np.abs(a64_k).max())

    def onset(a, tol):
        """The first step whose alpha sits more than tol·max|alpha_f64|
        from the f64 run's, or None."""
        far = np.nonzero(np.abs(a[:steps_df] - a64_k[:steps_df])
                         > tol * scale_a)[0]
        return int(far[0]) + 1 if len(far) else None
    print(f"[16] df solve(k={K}, f='inv') first call {df_first:.4f} s, "
          f"steps_taken {steps_df}, launches {df_launches}, plain df calls "
          f"{len(plain_df)}; pass two's v_{steps_df} bitwise pass one's in "
          f"hi and lo (n={n}); alpha, beta at k={K_CHECK} vs f64 (K8) "
          f"{da64:.3e} / {db64:.3e} <= 1e-11·max|alpha| {atol20:.3e}; K9 vs "
          f"plain df {err_k9:.3e}; K10 vs plain df rel {rel_k10:.3e}; small "
          f"instance vs CPU f64 oracle rel {rel_small_df:.3e}")
    print(f"     max|alpha - alpha_f64| (max|alpha_f64| {scale_a:.6e}): "
          + "; ".join(f"k<={kk}: df {d_:.3e}, f32 K2 {f_:.3e}"
                      for kk, (d_, f_) in drift.items()))
    print("     first step with |alpha - alpha_f64| > tol·max|alpha_f64|: "
          + "; ".join(f"tol {tol:g}: df {onset(al_df, tol)}, f32 K2 "
                      f"{onset(a32_k, tol)}" for tol in (1e-12, 1e-6, 1e-2)))

    t_df = wall_s(lambda: sdf.solve(b64, k=K, f="inv"), 5)
    ms["df_kkt_matvec"] = device_ms(
        lambda: df_kkt_matvec_cuda(dlay, dfop.d2, x2), 200)
    plain_ms["df_kkt_matvec"] = device_ms(
        lambda: dfop.plain_matvec_df(xdf), 20)
    lib64_ms = device_ms(lambda: torch.mv(a_csr64, x_sp), 200)
    ms["df_lanczos_pass_one"] = event_ms(lambda: sdf.pass_one(b2, K), 3)
    ms["df_lanczos_pass_two"] = event_ms(
        lambda: sdf.pass_two(b2, coeffs, y_h, y_l), 3)
    dec_k = kkt_fused_df.DFDecomposition(
        alphas=DF(coeffs[0], coeffs[1]), betas=DF(coeffs[2], coeffs[3]),
        steps_taken=coeffs[5].reshape(()),
        b_norm=DF(coeffs[4][0], coeffs[4][1]))
    bdf = DF(b2[0], b2[1])
    plain_ms["df_lanczos_pass_one"] = event_ms(
        lambda: kkt_fused_df._pass_one_df(dfop, bdf, K, False), 1)
    plain_ms["df_lanczos_pass_two"] = event_ms(
        lambda: kkt_fused_df._pass_two_df(dfop, bdf, dec_k, DF(y_h, y_l),
                                          False), 1)
    print(f"    on {card}: df two-pass solve k={K}: {runs(t_df)}")
    for name in ("df_kkt_matvec", "df_lanczos_pass_one",
                 "df_lanczos_pass_two"):
        print(f"    {name}: kernel {ms[name]:.5f} ms, plain "
              f"{plain_ms[name]:.5f} ms")
    print(f"    cuSPARSE f64 CSR SpMV (nnz {coo64.nnz}) {lib64_ms:.5f} ms")

    bounds = kernel_bounds(m, n, steps, K)
    for name in ("df_lanczos_pass_one", "df_lanczos_pass_two"):
        bounds[name] = kernel_bounds(m, n, steps_df, K)[name]
    library = {"kkt_matvec": lib_ms, "kkt_operator_matvec": lib_ms,
               "df_kkt_matvec": lib64_ms}
    errs = {"kkt_matvec": err_k1, "lanczos_pass_one": err_k2,
            "lanczos_pass_two": err_k3, "lanczos_pass_one_basis": err_k4,
            "lanczos_pass_one_chunk": err_k5, "lanczos_pass_one_comp": err_k6,
            "eft_check": err_k13, "kkt_operator_matvec": err_k8,
            "df_kkt_matvec": err_k11, "df_lanczos_pass_one": err_k9,
            "df_lanczos_pass_two": err_k10}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library.get(name)}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
