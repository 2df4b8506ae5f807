"""The port's ``entry.py`` against ``__graft_entry__.py``.

``_tiny_kkt`` gives the same arrays bit for bit; ``entry(device="cpu")``'s
forward step agrees with the JAX ``entry()``'s on the same arrays within rel
1e-5 (both f32 on the CPU: 5.4e-7 measured, the f64 solve being 2e-7 from
JAX's and 4e-7 from the port's); ``dryrun_multichip(n, device="cpu")``
passes on n ∈ {1, 2, 4} gloo ranks, and its checks raise when a leg is given
a wrong answer. Without a card the default device raises. The module
imports no jax at its top (``__graft_entry__.py`` imports it inside its
functions), so its card test runs where only PyTorch is set up::

    python -m pytest --noconftest tests/test_torch_entry.py -m requires_cuda
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from torch_cases import CPU, cuda_device  # noqa: F401
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch import entry as port
from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES, reset_launches

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,p,seed", [(256, 32, 0), (100, 9, 3)])
def test_tiny_kkt_is_bitwise_the_graft_entry(m, p, seed, dtype):
    ours = port._tiny_kkt(m, p, dtype, seed)
    ref = graft._tiny_kkt(m, p, dtype, seed)
    assert ours[3] == ref[3]
    for a, b in zip(ours[:3] + ours[4:], ref[:3] + ref[4:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_entry_forward_matches_the_graft_entry():
    import jax

    fn, args = graft.entry()
    xj = np.asarray(jax.jit(fn)(*args))
    forward, targs = port.entry(device="cpu")
    assert all(t.device == CPU for t in targs)
    for t, a in zip(targs, args):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    x = forward(*targs)
    assert x.shape == (288,) and x.dtype == torch.float32
    rel = np.linalg.norm(x.numpy() - xj) / np.linalg.norm(xj)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_passes_on_gloo_ranks(n):
    port.dryrun_multichip(n, device="cpu")


def _consistent_legs():
    """Legs that agree with the oracle, built on one CPU device: what a
    rank's :func:`run_legs` would return on a sound port."""
    d, u, v, p, b = port._tiny_kkt()
    oracle = port.oracle_legs(CPU)
    op = tpl.KKTOperator(d, u, v, p, device=CPU)
    x = tpl.solve_fAb(op, torch.from_numpy(b), k=8, f="inv").numpy()
    got = {"row": (x, 8), "row_one_pass": x, "fused": (x, 8),
           "df": (x.astype(np.float64), 3),
           "chebyshev": oracle["chebyshev"], "slq": oracle["slq"],
           "eigsh": (oracle["eigsh"], np.ones((2, x.size))),
           "block": oracle["block"], "fused_slq": oracle["slq"],
           "fused_chebyshev": oracle["fused_chebyshev"]}
    return got, oracle


def test_check_legs_passes_consistent_legs():
    got, oracle = _consistent_legs()
    port.check_legs(got, oracle)
    port.check_legs(dict(got, df=None), oracle)  # a rank outside the df mesh


def _scaled(a, s=1.01):
    return np.asarray(a) * s


WRONG = {
    "row_shape": lambda g: ("row", (g["row"][0][:-1], 8)),
    "row_nan": lambda g: ("row", (np.full_like(g["row"][0], np.nan), 8)),
    "row_steps": lambda g: ("row", (g["row"][0], 7)),
    "row_one_pass": lambda g: ("row_one_pass",
                               np.full_like(g["row_one_pass"], np.inf)),
    "fused_steps": lambda g: ("fused", (g["fused"][0], 5)),
    "fused_x": lambda g: ("fused", (_scaled(g["fused"][0]), 8)),
    "df_steps": lambda g: ("df", (g["df"][0], 2)),
    "df_nan": lambda g: ("df", (np.full_like(g["df"][0], np.nan), 3)),
    "chebyshev": lambda g: ("chebyshev", _scaled(g["chebyshev"])),
    "slq": lambda g: ("slq", g["slq"] * 1.01),
    "eigsh_values": lambda g: ("eigsh", (_scaled(g["eigsh"][0]),
                                         g["eigsh"][1])),
    "eigsh_vectors": lambda g: ("eigsh", (g["eigsh"][0],
                                          np.full((2, 288), np.nan))),
    "block": lambda g: ("block", _scaled(g["block"])),
    "fused_slq": lambda g: ("fused_slq", g["fused_slq"] * 0.99),
    "fused_chebyshev": lambda g: ("fused_chebyshev",
                                  _scaled(g["fused_chebyshev"], 0.99)),
}


@pytest.mark.parametrize("leg", sorted(WRONG))
def test_a_wrong_leg_raises(leg):
    got, oracle = _consistent_legs()
    key, value = WRONG[leg](got)
    with pytest.raises(port.DryRunError):
        port.check_legs(dict(got, **{key: value}), oracle)


def test_a_failing_rank_raises(monkeypatch):
    # a rank that exits non-zero fails the dry run with its stderr
    from two_pass_lanczos_tpu_torch.tools._spawn import RankResult
    monkeypatch.setattr(port, "spawn_ranks", lambda *a, **k: [
        RankResult(0, "", ""), RankResult(1, "", "DryRunError: slq")])
    with pytest.raises(port.DryRunError, match="rank\\(s\\) \\[1\\] of 2"):
        port.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip", "cli"])
def test_the_card_is_the_default(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"entry": lambda: port.entry(),
             "dryrun_multichip": lambda: port.dryrun_multichip(1),
             "cli": lambda: port._main([])}
    with pytest.raises(RuntimeError, match="cuda"):
        calls[call]()


def test_dryrun_multichip_refuses_zero_ranks():
    with pytest.raises(ValueError, match="n_devices"):
        port.dryrun_multichip(0, device="cpu")


def test_module_prints_the_graft_entry_lines():
    proc = subprocess.run(
        [sys.executable, "-m", "two_pass_lanczos_tpu_torch.entry",
         "--device", "cpu", "--ranks", "2"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines() == ["entry() ok: (288,) float32",
                                        "dryrun_multichip(2) ok"]


@pytest.mark.requires_cuda
def test_entry_launches_k8_31_times_on_card(cuda_device):  # noqa: F811
    forward, args = port.entry(device=cuda_device)
    assert all(t.device.type == "cuda" for t in args)
    reset_launches()
    x = forward(*args)
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    assert got == {"kkt_operator_matvec": 31}, got
    d, u, v, p, b = port._tiny_kkt()
    x64 = tpl.solve_fAb(tpl.KKTOperator(d.astype(np.float64), u, v, p,
                                        device=CPU),
                        torch.from_numpy(b.astype(np.float64)), k=16,
                        f="inv").numpy()
    rel = np.linalg.norm(x.cpu().numpy() - x64) / np.linalg.norm(x64)
    assert rel < 1e-3, rel
