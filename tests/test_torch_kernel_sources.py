"""The port's C interface and CUDA sources, checked without a card.

``ops/_build._SIGNATURES`` gives ctypes the argument types of every
``extern "C"`` entry point of ``two_pass_lanczos_tpu_torch/csrc/*.cu``. An
entry point that is missing there, or has fewer or other types, makes ctypes
pass a 64-bit pointer as a 32-bit int: the kernel gets a cut address and no
error is raised. The sources must also keep the rules of bitwise replay: no
atomic reduction on a float and no fast-math build flag; and the persistent
passes (K2, K3) launch cooperatively with no fallback to per-step launches,
and only K2 gets the larger pass-one scratch its C interface asks for; the
persistent passes' phase timer stamps one time per phase that
``ops/kkt_fused.PHASES`` names.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu_torch.ops import _build
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    FusedKKTSolver,
    PHASES,
    PassOneBuffers,
)

CSRC = _build.CSRC
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
_ENTRY = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(tpl_\w+)\s*\(([^)]*)\)\s*\{')
_DEFINE = re.compile(r"^#define\s+(\w+)[ \t]+((?:.*\\\n)*.*)$", re.M)


def _code(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def _entries() -> dict:
    """name -> (source file, [parameter declarations]) of every extern "C"
    function, object-like macros in the parameter list expanded."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        code = _code(path)
        macros = {name: body.replace("\\\n", " ")
                  for name, body in _DEFINE.findall(code)}
        for name, params in _ENTRY.findall(code):
            for macro, body in macros.items():
                params = re.sub(rf"\b{macro}\b", body, params)
            decls = [" ".join(d.split()) for d in params.split(",")]
            found[name] = (path.name,
                           [d for d in decls if d not in ("", "void")])
    return found


ENTRIES = _entries()


def _kind(decl: str) -> str:
    """The ctypes class a C parameter declaration needs."""
    if "*" in decl or decl.split()[0] == "cudaStream_t":
        return "pointer"
    base = decl.replace("const ", "").split()[0]
    return {"int": "int", "float": "float", "double": "double"}[base]


def _argkind(argtype) -> str:
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float",
            ctypes.c_double: "double"}[argtype]


def test_the_sources_export_the_known_entry_points():
    # the parser sees every entry point the build binds, and no other
    assert len(ENTRIES) >= 19
    assert set(ENTRIES) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_point_signature_matches_its_argtypes(name):
    src, decls = ENTRIES[name]
    argtypes = _build._SIGNATURES[name]
    assert len(argtypes) == len(decls), (src, decls)
    for i, (decl, argtype) in enumerate(zip(decls, argtypes)):
        assert _kind(decl) == _argkind(argtype), (src, i, decl, argtype)


def test_signature_parser_reads_macros_and_pointers():
    # K2's parameters come from the TPL_PASS_ONE_ARGS macro: 22 of them,
    # then the phase clock, the host counter and the stream
    _, decls = ENTRIES["tpl_lanczos_pass_one"]
    assert len(decls) == 25
    assert decls[0] == "const float *d" and decls[-1] == "cudaStream_t stream"
    assert [_kind(d) for d in decls[5:12]] == [
        "int", "int", "pointer", "int", "float", "float", "int"]
    assert _argkind(ctypes.POINTER(ctypes.c_int)) == "pointer"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_float_atomics_in_kernel_sources(path):
    code = _code(path)
    # atomic builtins of any type: none on the Lanczos path
    assert not re.search(r"\batomic\w*\s*\(", code)
    # nor a float atomic or reduction written in PTX
    assert not re.search(r"\b(atom|red)(\.\w+)*\.f(16|32|64)\b", code)


def test_build_flags_keep_ieee_rounding():
    flags = " ".join(_build.NVCC_FLAGS)
    for bad in ("fast_math", "fmad", "ftz=true", "prec-div=false",
                "prec-sqrt=false"):
        assert bad not in flags
    assert "-rdc" not in flags  # the grid sync needs no device linking


def test_persistent_passes_launch_cooperatively_without_fallback():
    header = _code(CSRC / "lanczos_persistent.cuh")
    assert "cudaLaunchCooperativeKernel" in header
    assert "this_grid().sync()" in header
    assert "<<<" not in header
    # K3 has one launch, the cooperative one: no per-step kernels remain
    two = _code(CSRC / "lanczos_pass_two.cu")
    assert "<<<" not in two and "launch_kkt_matvec" not in two
    assert two.count("launch_persistent(") == 1
    # K2 (uncompensated) returns the cooperative launch's error as it is
    one = _code(CSRC / "lanczos_pass_one.cu")
    body = one[one.index("int tpl_lanczos_pass_one("):]
    body = body[:body.index("\n}\n")]
    assert "launch_persistent(" in body
    assert body.count("tpl::run(") == 1 and "if (comp)" in body


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["per_step", "persistent"])
def test_pass_one_scratch_is_what_the_entry_point_needs(persistent):
    # lanczos_pass_one.cu: w (n; 2n for K2), flags (1 int; 1 + p for K2);
    # K4, K5 and K6 keep the per-step scratch
    lay = FusedKKTSolver(*random_kkt(np.random.default_rng(0)),
                         device=CPU).layout
    bufs = PassOneBuffers.alloc(lay, 7, persistent=persistent)
    assert tuple(bufs.w.shape) == ((2, lay.n) if persistent else (lay.n,))
    assert tuple(bufs.flags.shape) == ((1 + lay.p,) if persistent else (1,))
    assert tuple(bufs.state.shape) == (2, lay.n)
    assert bufs.alphas.shape == bufs.betas.shape == (7,)
    assert "2n for K2" in (CSRC / "lanczos_pass_one.cu").read_text()


def _kernel_body(code: str, name: str) -> str:
    body = code[code.index(name + "("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("path,kernel,name", [
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel", "lanczos_pass_one"),
    ("lanczos_pass_two.cu", "pass_two_persistent_kernel", "lanczos_pass_two")])
def test_phase_timer_stamps_every_phase_once(path, kernel, name):
    # a step stamps its start and the end of each phase of PHASES, in order,
    # and the entry point sizes the clock for as many stamps: phase_split
    # reads stamp e + 1 - stamp e as phase e
    code = _code(CSRC / path)
    stamps = [int(e) for e in re.findall(
        r"a\.clock\.stamp\(j, (\d+)\)", _kernel_body(code, kernel))]
    assert stamps == list(range(len(PHASES[name]) + 1))
    assert f"PhaseClock{{clock, k / 2, {len(stamps)}}}" in code
    # a null clock returns before the stamp's __syncthreads: a solve pays
    # one uniform branch a stamp
    header = _code(CSRC / "lanczos_persistent.cuh")
    stamp = _kernel_body(header, "void stamp")
    assert stamp.index("clock == nullptr") < stamp.index("__syncthreads")
