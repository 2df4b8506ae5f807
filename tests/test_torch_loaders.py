"""The port's loaders and models (``utils/data_loader.py``,
``models/kkt.py``, ``models/synthetic.py``) against the JAX package's on
the same files and seeds: identical arrays, the same errors, and the same
A from the matrix-free operator and the explicit assembly."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import CPU
from two_pass_lanczos_tpu.models import synthetic as jax_synthetic
from two_pass_lanczos_tpu.models.kkt import kkt_sorted_coo as jax_sorted_coo
from two_pass_lanczos_tpu.utils import data_loader as jax_dl
from two_pass_lanczos_tpu_torch import lanczos_two_pass, make_exp_solver
from two_pass_lanczos_tpu_torch.models.generator import (
    generate_mcf_instance,
    nodes_for,
)
from two_pass_lanczos_tpu_torch.models.kkt import (
    kkt_operator_from_files,
    kkt_sorted_coo,
)
from two_pass_lanczos_tpu_torch.models.synthetic import (
    SCENARIOS,
    create_diagonal_problem,
    dense_random_symmetric,
)
from two_pass_lanczos_tpu_torch.utils import data_loader as dl

REPO = Path(__file__).resolve().parents[1]

# the files of tests/test_loaders.py
DMX = """c comment line
p min 4 5
n 1 10
n 4 -10
a 1 2 0 5 3
a 2 3 0 5 3
a 3 4 0 5 3
a 1 3 0 5 3
a 2 4 0 5 3
"""
QFC = {
    "lines": "5\n1\n1\n1\n1\n1\n2.0\n3.0\n4.0\n5.0\n6.0\n",
    "spaces": "5\n1 1 1 1 1 \n2.0 3.0 4.0 5.0 6.0 \n",
    "quadonly": "5\n2.0 3.0 4.0 5.0 6.0\n",
}
BAD_DMX = {
    "noproblem": "c nothing here\na 1 2 0 5 3\n",
    "zeroidx": "p min 2 1\na 0 1 0 5 3\n",
    "range": "p min 2 1\na 1 9 0 5 3\n",
}


def _same_arrays(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_parse_dmx_matches_jax(tmp_path):
    f = tmp_path / "t.dmx"
    f.write_text(DMX)
    _same_arrays(dl.parse_dmx(f), jax_dl.parse_dmx(f))
    assert dl.parse_dmx(f)[:2] == (4, 5)


@pytest.mark.parametrize("name", sorted(BAD_DMX))
def test_parse_dmx_errors(tmp_path, name):
    f = tmp_path / f"{name}.dmx"
    f.write_text(BAD_DMX[name])
    for mod in (dl, jax_dl):
        with pytest.raises(mod.DataLoaderError):
            mod.parse_dmx(f)
        with pytest.raises(mod.DataLoaderError):
            mod._parse_dmx_py(f)


@pytest.mark.parametrize("layout", sorted(QFC))
def test_parse_qfc_matches_jax(tmp_path, layout):
    f = tmp_path / "t.qfc"
    f.write_text(QFC[layout])
    quad = dl.parse_qfc(f, 5)
    _same_arrays((quad,), (jax_dl.parse_qfc(f, 5),))
    np.testing.assert_array_equal(quad, [2.0, 3.0, 4.0, 5.0, 6.0])
    with pytest.raises(dl.DataLoaderError):
        dl.parse_qfc(f, 7)


@pytest.mark.parametrize("size", ["1000", "2000", "3000", "refgen"])
def test_load_kkt_arrays_matches_jax_on_vendored_data(size):
    for dmx in sorted((REPO / "data" / size).glob("*.dmx")):
        qfc = dmx.with_suffix(".qfc")
        _same_arrays(dl.load_kkt_arrays(dmx, qfc),
                     jax_dl.load_kkt_arrays(dmx, qfc))


def test_native_parser_matches_python(tmp_path):
    # the C++ parser in cpp/libtpl_native.so, loaded by the port's own
    # ctypes binding from the same repository root
    dl._NATIVE = None
    lib = dl._native_lib()
    if lib is None:
        pytest.skip("cpp/libtpl_native.so is not built")
    f = tmp_path / "t.dmx"
    f.write_text(DMX)
    _same_arrays(dl.parse_dmx(f), dl._parse_dmx_py(f))
    dmx = sorted((REPO / "data" / "refgen").glob("*.dmx"))[0]
    _same_arrays(dl.parse_dmx(dmx), dl._parse_dmx_py(dmx))
    for name, content in BAD_DMX.items():
        g = tmp_path / f"{name}.dmx"
        g.write_text(content)
        with pytest.raises(dl.DataLoaderError):
            dl.parse_dmx(g)


def test_kkt_operator_matches_dense_assembly(tmp_path):
    (tmp_path / "t.dmx").write_text(DMX)
    (tmp_path / "t.qfc").write_text(QFC["spaces"])
    sys = kkt_operator_from_files(tmp_path / "t.dmx", tmp_path / "t.qfc",
                                  device=CPU)
    assert (sys.num_nodes, sys.num_arcs, sys.n) == (4, 5, 9)
    assert sys.operator.dtype == torch.float64
    arrays = dl.load_kkt_arrays(tmp_path / "t.dmx", tmp_path / "t.qfc")
    dense = kkt_sorted_coo(arrays, device=CPU).todense().numpy()
    ref = np.asarray(jax_sorted_coo(jax_dl.load_kkt_arrays(
        tmp_path / "t.dmx", tmp_path / "t.qfc")).todense())
    np.testing.assert_array_equal(dense, ref)
    np.testing.assert_allclose(np.diag(dense)[:5], [2, 3, 4, 5, 6])
    np.testing.assert_allclose(dense, dense.T)
    assert np.all(dense[5:, 5:] == 0)
    x = np.random.default_rng(3).standard_normal(9)
    np.testing.assert_allclose(sys.operator.matvec(torch.from_numpy(x)).numpy(),
                               dense @ x, atol=1e-14)


def test_generator_roundtrip_through_the_port_loader(tmp_path):
    inst = generate_mcf_instance(200, rho=3, instance_id=7,
                                 output_dir=tmp_path)
    base = "netgen-200-3-7-a-a-ns"
    arrays = dl.load_kkt_arrays(tmp_path / f"{base}.dmx",
                                tmp_path / f"{base}.qfc")
    assert arrays.num_arcs == 200 and arrays.num_nodes == nodes_for(200, 3)
    np.testing.assert_allclose(arrays.quad_costs, inst.quad_costs, rtol=1e-6)
    np.testing.assert_array_equal(arrays.arc_u, inst.arc_u)
    np.testing.assert_array_equal(arrays.arc_v, inst.arc_v)


@pytest.mark.parametrize("func,scenario", SCENARIOS)
def test_synthetic_scenarios_match_jax(func, scenario):
    op, eigs = create_diagonal_problem(100, scenario, func, device=CPU)
    jop, jeigs = jax_synthetic.create_diagonal_problem(100, scenario, func)
    np.testing.assert_array_equal(eigs, jeigs)
    np.testing.assert_array_equal(op.diag.numpy(), np.asarray(jop.diag))
    assert op.dtype == torch.float64 and op.device == CPU
    with pytest.raises(ValueError):
        create_diagonal_problem(10, scenario, "log", device=CPU)


def test_dense_random_symmetric_matches_jax():
    op = dense_random_symmetric(64, device=CPU)
    ref = jax_synthetic.dense_random_symmetric(64)
    np.testing.assert_array_equal(op.a.numpy(), np.asarray(ref.a))
    x = np.random.default_rng(0).standard_normal(64)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_stability_accuracy_on_reference_scenarios():
    # exp / well-conditioned reaches machine precision in < 30 steps
    n, k = 2000, 30
    op, eigs = create_diagonal_problem(n, "well-conditioned", "exp",
                                       device=CPU)
    b = np.random.default_rng(42).standard_normal(n)
    x = lanczos_two_pass(op, b, k, make_exp_solver()).numpy()
    x_true = np.exp(eigs) * b
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-13
