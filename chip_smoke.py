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
7. wall times of k = 500 and k = 1000 solves and of each kernel, beside the
   plain PyTorch path on the same card.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this file, it prints no result and exits 2.
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
KERNELS = {
    "kkt_matvec": ("two_pass_lanczos_tpu_torch/csrc/kkt_matvec.cu",
                   "two_pass_lanczos_tpu/ops/kkt_fused.py:924"),
    "lanczos_pass_one": ("two_pass_lanczos_tpu_torch/csrc/lanczos_pass_one.cu",
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:581"),
    "lanczos_pass_two": ("two_pass_lanczos_tpu_torch/csrc/lanczos_pass_two.cu",
                         "two_pass_lanczos_tpu/ops/kkt_fused.py:841"),
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
        pass_one_last_vector,
        pass_one_scan,
        pass_two_scan,
    )
    from two_pass_lanczos_tpu_torch.ops import _build
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
        LAUNCHES,
        kkt_matvec_cuda,
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
    launches = dict(LAUNCHES)
    check(all(launches[k] > 0 for k in KERNELS), f"launches {launches}")
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

    # 7. timings (the Lanczos state is L2-resident in a real pass, so the
    #    kernels are timed warm, back to back)
    def solve_k(k):
        return lambda: solver.solve(b, k=k, f="inv", raw=True)

    def plain_solve():
        d_, _ = pass_one_scan(plain_mv, b, K)
        yy = torch.where(torch.arange(K, device=dev) < d_.steps_taken,
                         padded_f_e1(d_, "inv") * d_.b_norm, 0.0)
        return pass_two_scan(plain_mv, b, d_, yy)

    t_plain1 = wall_s(plain_solve, 1)
    t500 = wall_s(solve_k(K), 5)
    t1000 = wall_s(solve_k(K_LONG), 3)
    t_plain2 = wall_s(plain_solve, 1)
    ms = {
        "kkt_matvec": event_ms(lambda: kkt_matvec_cuda(lay, x), 200),
        "lanczos_pass_one": event_ms(
            lambda: pass_one_cuda(lay, b, K, solver.tol, solver.ztol), 3),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_cuda(lay, b, dec1, y_full, solver.ztol), 3),
    }
    plain_ms = {
        "kkt_matvec": event_ms(lambda: plain_mv(x), 200),
        "lanczos_pass_one": event_ms(lambda: pass_one_scan(plain_mv, b, K), 1),
        "lanczos_pass_two": event_ms(
            lambda: pass_two_scan(plain_mv, b, dec1, y_full), 1),
    }
    print(f"[7] on {card}:")
    print(f"    solve k={K}: median {statistics.median(t500):.4f} s "
          f"(runs {', '.join(f'{t:.4f}' for t in t500)})")
    print(f"    solve k={K_LONG}: median {statistics.median(t1000):.4f} s "
          f"(runs {', '.join(f'{t:.4f}' for t in t1000)})")
    print(f"    plain PyTorch solve k={K} on the card: "
          f"{', '.join(f'{t:.4f}' for t in t_plain1 + t_plain2)} s")
    for name in KERNELS:
        print(f"    {name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.4f} ms")

    errs = {"kkt_matvec": err_k1, "lanczos_pass_one": err_k2,
            "lanczos_pass_two": err_k3}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
