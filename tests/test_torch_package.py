"""The PyTorch port as a package: no jax, bit-identical generator, no
silent CPU fallback, and the rules its CUDA sources keep."""

import ast
import importlib
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


@pytest.mark.parametrize("name", ["test_torch_cuda.py", "torch_ranks.py"])
def test_card_tests_import_no_jax(name):
    # the card tests run with --noconftest, without the JAX package, and
    # the sharded solvers' ranks (tests/torch_ranks.py) import torch only
    tree = ast.parse((ROOT / "tests" / name).read_text())
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


def test_no_jax_checks_cover_the_distributed_tier():
    checked = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/comm.py",
            "parallel/fused_sharded.py", "parallel/fused_sharded_df.py",
            "parallel/partition.py", "parallel/sharded.py",
            "utils/collectives.py", "probes/__init__.py", "probes/__main__.py",
            "probes/bench.py", "probes/gather.py", "probes/stream.py",
            "probes/stages.py", "probes/pipeline.py"} <= checked


def test_no_jax_checks_cover_the_experiments_and_tools():
    checked = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {f"experiments/{m}.py" for m in (
        "__init__", "common", "tradeoff", "scalability", "datagen",
        "dense_tradeoff", "stability", "orthogonality", "certificate_study",
        "reorth_study")} <= checked
    assert {"utils/perf.py", "utils/sol_bench.py", "tools/__init__.py",
            "tools/_spawn.py", "tools/sol_bench.py", "tools/scaling_bench.py",
            "tools/multihost_smoke.py", "tools/collective_audit.py"} <= checked
    # the twin of __graft_entry__.py
    assert "entry.py" in checked
    # the nine CLIs of the JAX package, one for one
    jax_cli = {p.name for p in (ROOT / "two_pass_lanczos_tpu" / "experiments")
               .glob("*.py")}
    assert jax_cli == {p.name for p in (PKG / "experiments").glob("*.py")}


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


#: names of the JAX package's ``__all__`` the port does not have:
#: ``PallasKKTOperator``, whose counterpart is ``CudaKKTOperator``
NOT_PORTED = {"PallasKKTOperator"}


def test_port_exports_the_jax_names():
    import two_pass_lanczos_tpu as jtpl
    import two_pass_lanczos_tpu_torch as port

    assert set(jtpl.__all__) - set(port.__all__) == NOT_PORTED
    assert all(hasattr(port, name) for name in port.__all__)
    assert "CudaKKTOperator" in port.__all__


#: names of each JAX subpackage's ``__all__`` the port does not have: the
#: TPU layout (ROADMAP "Not ported")
SUB_NOT_PORTED = {
    "algorithms": set(),
    "ops": {"SortedKKTLayout"},
    "utils": set(),
}


@pytest.mark.parametrize("sub", sorted(SUB_NOT_PORTED))
def test_subpackages_export_the_jax_names(sub):
    jax_sub = importlib.import_module(f"two_pass_lanczos_tpu.{sub}")
    port_sub = importlib.import_module(f"two_pass_lanczos_tpu_torch.{sub}")
    assert set(jax_sub.__all__) - set(port_sub.__all__) == SUB_NOT_PORTED[sub]
    assert all(hasattr(port_sub, name) for name in port_sub.__all__)


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


def test_chip_smoke_shard_bounds_count_each_input_once():
    mod = _load_script("chip_smoke")
    # one shard's matvec computes the matvec's function: K7 is K1's bound,
    # K12 is K11's
    for m, p in ((500_000, 1155), (5_000_000, 3651)):
        bounds = mod.kernel_bounds(m, m + p, 500, 500)
        assert bounds["kkt_streaming_matvec"] == bounds["kkt_matvec"]
        assert bounds["df_kkt_streaming_matvec"] == bounds["df_kkt_matvec"]
    # at 5M arcs: 20·m + 8·p = 100.0 MB and 32·m + 16·p = 160.1 MB
    ms, by = bounds["kkt_streaming_matvec"]
    assert by == "bytes" and ms == pytest.approx(0.02986, rel=1e-3)
    ms, by = bounds["df_kkt_streaming_matvec"]
    assert by == "bytes" and ms == pytest.approx(0.04777, rel=1e-3)
    assert set(mod.KERNELS) <= set(bounds)


def test_chip_smoke_step_bounds_count_each_input_once():
    mod = _load_script("chip_smoke")
    m, p = 1_250_000, 3651
    n = m + p
    bounds = mod.step_bounds(m, p, 4, 1)
    # K7's step instances: K7's 20 B an arc less y_a, with v_prev_a read
    # and w_a written (+4 B), or v_prev_a read, v_next_a written and x_a
    # read and written (+12 B); the block partials besides
    ms, by = bounds["kkt_shard_matvec_step_one"]
    assert by == "bytes" and ms == pytest.approx(
        (24 * m + 8 * p + 4 * -(-m // 256)) / 3.35e12 * 1e3)
    ms, by = bounds["kkt_shard_matvec_step_two"]
    assert by == "bytes"
    assert ms == pytest.approx((32 * m + 8 * p) / 3.35e12 * 1e3)
    # the vector kernels: w and v read and w written; w read and written
    ms, by = bounds["shard_step_orthogonalise"]
    assert by == "bytes" and 12 * n / 3.35e9 < ms < 12.01 * n / 3.35e9
    ms, by = bounds["shard_step_advance"]
    assert by == "bytes" and 8 * n / 3.35e9 < ms < 8.01 * n / 3.35e9
    # the node kernels touch p rows and the shares only
    for name in ("shard_step_node_fold", "shard_step_norm",
                 "shard_step_two_nodes"):
        assert bounds[name][0] < 1e-4
    # a second row of y reads and writes x once more
    two = mod.step_bounds(m, p, 4, 2)
    assert two["kkt_shard_matvec_step_two"][0] == pytest.approx(
        bounds["kkt_shard_matvec_step_two"][0] + 8 * m / 3.35e9)


def test_chip_smoke_step_phase_holds_each_kernel_to_its_plain_version():
    """Phase 17b's checks, run on the CPU with the plain kernels on both
    sides: every comparison it makes passes, and it reports each kernel."""
    mod = _load_script("chip_smoke")
    big = generate_mcf_instance(20_000, rho=3, instance_id=1)
    out = mod.shard_step_phase("cpu", torch.device("cpu"), big, timed=False)
    assert set(out) == set(mod.STEP_ROWS)
    assert all(row["err"] == 0.0 for row in out.values())
    assert set(mod.STEP_ROWS) <= set(mod.KERNELS)


def test_chip_smoke_probe_bounds_count_each_input_once():
    mod = _load_script("chip_smoke")
    m, p = 5_000_000, 3651
    bounds = mod.kernel_bounds(m, m + p, 500, 500)
    # the stage and pipeline probes compute K7's function
    assert bounds["probe_stages"] == bounds["probe_pipeline"] \
        == bounds["kkt_streaming_matvec"]
    # the stream: d, u, v, x in and y out, 20 bytes an arc
    assert bounds["probe_stream"] == (pytest.approx(20 * m / 3.35e12 * 1e3),
                                      "bytes")
    # x_n[u]: an int32 index in and an f32 out per arc, the table once
    assert bounds["probe_gather"][0] == pytest.approx(
        (8 * m + 4 * p) / 3.35e12 * 1e3)
    # every probe in the kernels line names its variant and a TPU probe
    assert set(mod.PROBE_MAIN) == {k for k in mod.KERNELS
                                   if k.startswith("probe_")}
    for name in mod.PROBE_MAIN:
        src, rep = mod.KERNELS[name]
        assert (ROOT / src).is_file() and rep.startswith("scripts/")
        assert (ROOT / rep.split(":")[0]).is_file()


def test_chip_smoke_csr_spmv_bound_counts_each_input_once():
    mod = _load_script("chip_smoke")
    n, nnz = 501_155, 2_500_000
    # f32: 8 bytes a nonzero, 4 a row pointer, x and y; the benchmark's
    # counts.coo_spmv, whose 7.77 us the spmv_roofline metric divides
    assert mod.csr_spmv_bound(nnz, n, n, 4, False) == (
        pytest.approx((8 * nnz + 4 * (n + 1) + 8 * n) / 3.35e12 * 1e3),
        "bytes")
    assert mod.csr_spmv_bound(nnz, n, n, 4, False)[0] == pytest.approx(
        7.765e-3, rel=1e-3)
    # c128: a 16-byte value and a 4-byte index a nonzero, 16-byte x and y
    assert mod.csr_spmv_bound(5, 3, 4, 16, True)[0] == pytest.approx(
        (20 * 5 + 4 * 4 + 16 * 7) / 3.35e12 * 1e3)
    # the kernels line's row: the headline's assembled KKT, 5 nonzeros an arc
    assert mod.kernel_bounds(500_000, n, 500, 500)["csr_spmv"] == \
        mod.csr_spmv_bound(nnz, n, n, 4, False)
    src, rep = mod.KERNELS["csr_spmv"]
    assert (ROOT / src).is_file() and rep is None  # replaces no TPU kernel


def test_profile_busy_is_the_union_of_device_intervals():
    mod = _load_script("profile_port")
    # overlapping, nested, touching and disjoint intervals, in any order
    events = [("a", 10.0, 20.0), ("b", 0.0, 5.0), ("c", 15.0, 30.0),
              ("d", 16.0, 18.0), ("e", 30.0, 31.0), ("f", 40.0, 42.0)]
    assert mod.busy_us(events) == 5.0 + 21.0 + 2.0
    assert mod.busy_us([]) == 0.0


def test_profile_overlap_counts_time_beside_other_kernels():
    mod = _load_script("profile_port")
    events = [("ncclKernel_AllGather", 10.0, 20.0),
              ("DeviceSegmentedReduceKernel", 5.0, 12.0),
              ("mul", 15.0, 16.0), ("mul", 15.5, 17.0),
              ("ncclKernel_AllGather", 30.0, 31.0), ("add", 40.0, 41.0)]
    total, over, hit = mod.overlap_us(events, mod.is_nccl,
                                      lambda n: not mod.is_nccl(n))
    assert total == 11.0 and over == 2.0 + 2.0 and hit == 1
    total, over, hit = mod.overlap_us(events, mod.is_nccl,
                                      mod.is_segment_reduce)
    assert (total, over, hit) == (11.0, 2.0, 1)
    assert mod.is_segment_reduce(
        "void at_cuda_detail::cub::DeviceSegmentedReduceKernel<at_cud")
    assert mod.is_segment_reduce(
        "void tpl::(anonymous namespace)::csr_spmv_kernel<float>(float "
        "const*, long long const*, long long const*, long long const*, "
        "int, float const*, float*)")
    assert not mod.is_segment_reduce("void tpl::kkt_matvec_kernel<float, "
                                     "false>(float const*, int const*)")
    assert mod.overlap_us([], mod.is_nccl, mod.is_nccl) == (0.0, 0.0, 0)
    # a copy inside a NCCL range is not compute
    assert not mod.is_compute("Memcpy DtoD (Device -> Device)")
    assert not mod.is_compute("nccl:_all_gather_base")
    assert mod.is_compute("void at::native::index_elementwise_kernel<128>")


def test_kernel_sources_keep_the_rules():
    # no atomics on the Lanczos path (they break bitwise replay), and no
    # fast math (approximate 1/beta and sqrt, flushed subnormals)
    sources = sorted(PKG.glob("csrc/*.cu")) + sorted(PKG.glob("csrc/*.cuh"))
    assert {p.name for p in sources} >= {
        "kkt_matvec.cu", "lanczos_pass_one.cu", "lanczos_pass_two.cu",
        "eft_check.cu", "lanczos_common.cuh", "df_common.cuh",
        "df_kkt_matvec.cu", "df_lanczos_pass_one.cu",
        "df_lanczos_pass_two.cu", "kkt_shard_matvec.cu",
        "df_kkt_shard_matvec.cu", "probe_common.cuh", "probe_gather.cu",
        "probe_stream.cu", "probe_stages.cu", "probe_pipeline.cu"}
    for p in sources:
        assert not re.search(r"\batomic\w*\s*\(", p.read_text()), p.name
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_profile_innermost_span_of_nested_spans():
    mod = _load_script("profile_port")
    spans = [("tpl.solve", 0.0, 100.0), ("tpl.pass_one", 1.0, 40.0),
             ("tpl.spmv", 2.0, 3.0), ("tpl.spmv", 5.0, 6.0),
             ("tpl.f_tk", 41.0, 50.0), ("tpl.pass_two", 51.0, 99.0)]
    times = [120.0, -1.0, 0.5, 2.5, 4.0, 45.0, 99.5, 5.5]
    assert mod.innermost(spans, times) == [
        None, None, "tpl.solve", "tpl.spmv", "tpl.pass_one", "tpl.f_tk",
        "tpl.solve", "tpl.spmv"]
    assert mod.innermost([], [1.0]) == [None]


def _span_trace():
    """Two calls of a solve: pass one's kernel, f(T_k)'s kernel after a
    wait for the device, pass two's kernel launched late; the call's
    closing synchronise lies outside ``tpl.solve``."""
    host, device = [], []
    for c, t0 in enumerate((0.0, 200.0)):
        i = 10 * c
        host += [("profile_port.call", t0, t0 + 100.0, i + 1),
                 ("tpl.solve", t0 + 1.0, t0 + 60.0, i + 2),
                 ("tpl.pass_one", t0 + 2.0, t0 + 10.0, i + 3),
                 ("cudaLaunchCooperativeKernel", t0 + 3.0, t0 + 4.0, i + 4),
                 ("tpl.f_tk", t0 + 10.0, t0 + 50.0, i + 5),
                 ("cudaLaunchKernel", t0 + 11.0, t0 + 12.0, i + 6),
                 ("cudaStreamSynchronize", t0 + 13.0, t0 + 45.0, i + 7),
                 ("tpl.pass_two", t0 + 50.0, t0 + 60.0, i + 8),
                 ("cudaLaunchCooperativeKernel", t0 + 55.0, t0 + 56.0,
                  i + 9),
                 ("cudaDeviceSynchronize", t0 + 61.0, t0 + 99.0, i + 10)]
        # (the device runs pass one to t0 + 40, f(T_k) to 44, pass two
        # from 57 to 98)
        device += [("pass_one_persistent_kernel", t0 + 5.0, t0 + 40.0,
                    i + 4),
                   ("getrf_pivot", t0 + 41.0, t0 + 44.0, i + 6),
                   ("pass_two_persistent_kernel", t0 + 57.0, t0 + 98.0,
                    i + 9)]
    # a launch between the calls (drawing the next b) is in none
    host.append(("cudaLaunchKernel", 150.0, 151.0, 99))
    device.append(("randn", 152.0, 153.0, 99))
    return device, host


def test_profile_span_breakdown_assigns_idle_waits_and_launches():
    mod = _load_script("profile_port")
    device, host = _span_trace()
    r = mod.span_breakdown(device, host, "profile_port.call")
    # idle a call: [0, 5) (none 1, solve 1, pass one 3), [40, 41) and
    # [44, 50) in f(T_k), [50, 57) in pass two, [98, 100) in none
    assert r["idle_ms"] == pytest.approx({
        "none": 3e-3, "tpl.solve": 1e-3, "tpl.pass_one": 3e-3,
        "tpl.f_tk": 7e-3, "tpl.pass_two": 7e-3})
    busy = mod.busy_us([(n, s, e) for n, s, e, _ in device[:6]])
    assert sum(r["idle_ms"].values()) * 2 == pytest.approx(
        (200.0 - busy) / 1e3)
    # the closing synchronise is outside tpl.solve
    assert r["host_syncs"] == {"tpl.f_tk": 1.0}
    # pass two's kernel starts after its span: placed by its launch
    assert r["launches"] == {
        "tpl.f_tk": [["getrf_pivot", 1.0]],
        "tpl.pass_one": [["pass_one_persistent_kernel", 1.0]],
        "tpl.pass_two": [["pass_two_persistent_kernel", 1.0]]}
    assert r["misaligned_ms"] == 0.0
    # a device clock 3 µs late: pass two's kernel ends past its call
    late = [(n, s + 3.0, e + 3.0, i) for n, s, e, i in device]
    assert mod.span_breakdown(late, host, "profile_port.call")[
        "misaligned_ms"] == pytest.approx(1e-3)
    assert mod.span_breakdown(device, [h for h in host
                                       if not h[0].startswith("tpl.")],
                              "profile_port.call") == {}


def test_profile_trace_events_skip_the_devices_copies_of_annotations():
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    mod = _load_script("profile_port")

    def ev(name, kind, annotation=False, ident=1):
        return SimpleNamespace(
            name=name, id=ident, device_type=kind,
            is_user_annotation=annotation,
            time_range=SimpleNamespace(start=1.0, end=2.0))

    prof = SimpleNamespace(events=lambda: [
        ev("tpl.solve", DeviceType.CPU, True),
        ev("tpl.solve", DeviceType.CUDA, True),
        ev("cudaLaunchKernel", DeviceType.CPU, ident=7),
        ev("getrf_pivot", DeviceType.CUDA, ident=7)])
    device, host = mod.trace_events(prof)
    assert device == [("getrf_pivot", 1.0, 2.0, 7)]
    assert [h[0] for h in host] == ["tpl.solve", "cudaLaunchKernel"]


def test_profile_reports_a_paths_spans(monkeypatch):
    # the card's trace stood in for: the CPU trace, one device operation
    # at the start of each profiled call
    from tests.torch_cases import random_kkt
    from two_pass_lanczos_tpu_torch import FusedKKTSolver
    mod = _load_script("profile_port")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = mod.trace_events

    def one_kernel_a_call(prof):
        _, host = real(prof)
        return [("kernel", s, s + 1.0, 0) for name, s, _, _ in host
                if name == mod.CALL], host

    monkeypatch.setattr(mod, "trace_events", one_kernel_a_call)
    s = FusedKKTSolver(*random_kkt(np.random.default_rng(3), 60, 20),
                       device="cpu")
    b = torch.ones(s.n)
    r = mod.profile(lambda: s.solve(b, k=6, raw=True), reps=2)
    assert r["events"] == 1.0 and r["host_top"]
    assert {"tpl.pass_one", "tpl.f_tk", "tpl.pass_two"} <= set(
        r["spans"]["idle_ms"])
    assert r["spans"]["launches"] == {"none": [["kernel", 1.0]]}
