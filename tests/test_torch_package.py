"""The PyTorch port as a package: no jax, bit-identical generator, no
silent CPU fallback, and the rules its CUDA sources keep."""

import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu.models.generator import (
    generate_mcf_instance as jax_generate,
)
from two_pass_lanczos_tpu_torch import FusedKKTSolver, generate_mcf_instance
from two_pass_lanczos_tpu_torch.observability import df_kkt_matvec_bytes
from two_pass_lanczos_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "two_pass_lanczos_tpu_torch"


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")))
def test_module_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "two_pass_lanczos_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_card_tests_import_no_jax():
    # the card tests run with --noconftest, without the JAX package
    tree = ast.parse((ROOT / "tests" / "test_torch_cuda.py").read_text())
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "two_pass_lanczos_tpu")]
    assert not bad, bad
    cases = ast.parse((ROOT / "tests" / "torch_cases.py").read_text())
    assert not [m for m in _imports(cases) if m.split(".")[0] == "jax"]


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_port.py"])
def test_card_scripts_import_no_jax(script):
    tree = ast.parse((ROOT / script).read_text())
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("jax", "jaxlib", "two_pass_lanczos_tpu")]
    assert not bad, f"{script} imports {bad}"


def test_import_leaves_jax_out():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in sys.modules, 'jax imported'\n"
            + "assert 'two_pass_lanczos_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


#: names of the JAX package's ``__all__`` the port does not have yet: the
#: capability layer (ROADMAP Queue 1 item 6); ``PallasKKTOperator``'s
#: counterpart is ``CudaKKTOperator``
NOT_PORTED = {
    "PallasKKTOperator",
    "ritz_values", "ritz_pairs", "ritz_residual_bounds", "quadratic_form",
    "gauss_radau_bracket", "quadrature_bracket", "a_norm_error_history",
    "eigsh", "EigshResult", "chebyshev_fAb", "chebyshev_coefficients",
    "estimate_interval", "BlockDecomposition", "block_pass_one",
    "block_pass_two", "block_padded_f_e1", "solve_fAb_block",
    "solve_fAb_block_jit", "SLQResult", "lanczos_pass_one_batched",
    "batched_quadratic_form", "batched_ritz_weights", "slq_trace",
    "slq_trace_adaptive", "slq_logdet", "slq_spectral_density",
}


def test_port_exports_the_jax_names():
    import two_pass_lanczos_tpu as jtpl
    import two_pass_lanczos_tpu_torch as port

    assert set(jtpl.__all__) - set(port.__all__) == NOT_PORTED
    assert all(hasattr(port, name) for name in port.__all__)
    assert "CudaKKTOperator" in port.__all__


@pytest.mark.parametrize("arcs,rho,iid", [
    (60, 1, 1), (300, 2, 7), (1000, 3, 2), (5000, 3, 3), (500_000, 3, 1)])
def test_generator_bit_identical(arcs, rho, iid):
    ours = generate_mcf_instance(arcs, rho=rho, instance_id=iid)
    ref = jax_generate(arcs, rho=rho, instance_id=iid)
    assert ours.num_nodes == ref.num_nodes and ours.num_arcs == ref.num_arcs
    for name in ("arc_u", "arc_v", "lin_costs", "capacities", "fixed_costs",
                 "quad_costs", "supplies"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_headline_instance_shape():
    inst = generate_mcf_instance(500_000, rho=3, instance_id=1)
    assert (inst.num_arcs, inst.num_nodes) == (500_000, 1155)


def test_cuda_solver_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    d = np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        FusedKKTSolver(d, [0, 1, 2], [1, 2, 0], 3, device="cuda")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_profile_port_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: profile_port.py would run")
    out = tmp_path / "p.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "profile_port.py"), "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not out.exists()


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_count_each_input_once():
    mod = _load_script("chip_smoke")
    m, p, k = 500_000, 1155, 500
    n = m + p
    bounds = mod.kernel_bounds(m, n, k, k)
    # one matvec: d, u, v, x read once and y written once (10.0 MB), not the
    # layout's incidence CSR
    assert bounds["kkt_operator_matvec"] == bounds["kkt_matvec"]
    ms, by = bounds["kkt_operator_matvec"]
    assert by == "bytes"
    assert ms == pytest.approx((20 * m + 8 * p) / 3.35e12 * 1e3)
    # a pass reads its inputs once, whatever it reads again per step, so its
    # f32 operations bind
    ms, by = bounds["lanczos_pass_one"]
    assert by == "operations"
    assert ms == pytest.approx(k * (5 * m + 9 * n) / 67e12 * 1e3)
    # the one-pass basis is written once: its 4·k·n bytes bind
    ms, by = bounds["lanczos_pass_one_basis"]
    assert by == "bytes" and ms > 4 * k * n / 3.35e12 * 1e3
    assert bounds["eft_check"][0] < 1e-5


def test_chip_smoke_df_bounds_count_each_input_once():
    mod = _load_script("chip_smoke")
    m, p, k = 500_000, 1155, 500
    n = m + p
    bounds = mod.kernel_bounds(m, n, k, k)
    # K11: d, x, y as hi/lo pairs and u, v, each once: 32·m + 16·p bytes
    # (16.0 MB), the observability model's function bytes
    ms, by = bounds["df_kkt_matvec"]
    assert by == "bytes"
    assert ms == pytest.approx((32 * m + 16 * p) / 3.35e12 * 1e3)
    assert df_kkt_matvec_bytes(m, p) == 32 * m + 16 * p
    # the df passes read their inputs once: their df operations bind, ~10x
    # the f32 passes'
    for name, f32 in (("df_lanczos_pass_one", "lanczos_pass_one"),
                      ("df_lanczos_pass_two", "lanczos_pass_two")):
        ms, by = bounds[name]
        assert by == "operations"
        assert 8 * bounds[f32][0] < ms < 20 * bounds[f32][0]


def test_profile_busy_is_the_union_of_device_intervals():
    mod = _load_script("profile_port")
    # overlapping, nested, touching and disjoint intervals, in any order
    events = [("a", 10.0, 20.0), ("b", 0.0, 5.0), ("c", 15.0, 30.0),
              ("d", 16.0, 18.0), ("e", 30.0, 31.0), ("f", 40.0, 42.0)]
    assert mod.busy_us(events) == 5.0 + 21.0 + 2.0
    assert mod.busy_us([]) == 0.0


def test_kernel_sources_keep_the_rules():
    # no atomics on the Lanczos path (they break bitwise replay), and no
    # fast math (approximate 1/beta and sqrt, flushed subnormals)
    sources = sorted(PKG.glob("csrc/*.cu")) + sorted(PKG.glob("csrc/*.cuh"))
    assert {p.name for p in sources} >= {
        "kkt_matvec.cu", "lanczos_pass_one.cu", "lanczos_pass_two.cu",
        "eft_check.cu", "lanczos_common.cuh", "df_common.cuh",
        "df_kkt_matvec.cu", "df_lanczos_pass_one.cu",
        "df_lanczos_pass_two.cu"}
    for p in sources:
        assert not re.search(r"\batomic\w*\s*\(", p.read_text()), p.name
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
