"""The port's C interface and CUDA sources, checked without a card.

``ops/_build._SIGNATURES`` gives ctypes the argument types of every
``extern "C"`` entry point of ``two_pass_lanczos_tpu_torch/csrc/*.cu``. An
entry point that is missing there, or has fewer or other types, makes ctypes
pass a 64-bit pointer as a 32-bit int: the kernel gets a cut address and no
error is raised. The sources must also keep the rules of bitwise replay: no
atomic reduction on a float and no fast-math build flag; and the persistent
passes (K2, K3 and the double-float K9, K10) launch cooperatively with no
fallback to per-step launches, read what the launch writes with no
read-only load, and get the scratch their C interfaces ask for; their phase
timer stamps one time per phase that ``ops/kkt_fused.PHASES`` names.
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
    MAX_PARTIALS,
    PHASES,
    PassOneBuffers,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import DFPassOneScratch

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


def _entry_body(code: str, name: str) -> str:
    """The body of extern "C" function ``name``, comments stripped."""
    body = code[code.index(f"int {name}("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("src,entry,kernel", [
    ("df_lanczos_pass_one.cu", "tpl_df_lanczos_pass_one",
     "df_pass_one_persistent_kernel"),
    ("df_lanczos_pass_two.cu", "tpl_df_lanczos_pass_two",
     "df_pass_two_persistent_kernel")])
def test_df_persistent_passes_launch_cooperatively_without_fallback(
        src, entry, kernel):
    # K9 and K10: one cooperative launch each (built with or without the
    # timer), whose error the entry point returns as it is; the per-step
    # launches they replaced live on only in the *_steps entry point
    code = _code(CSRC / src)
    assert code.count("launch_persistent(") == 1
    body = _entry_body(code, entry)
    assert "<<<" not in body and "_steps" not in body
    assert "enqueue_" not in body and "launch_df_kkt_matvec" not in body
    assert "launch_pass_" in body and "return static_cast<int>(err)" in body
    assert "<<<" not in _kernel_body(code, kernel)
    steps = _entry_body(code, entry + "_steps")
    assert "launch_persistent" not in steps and "launch_pass_" not in steps
    assert "launch_df_kkt_matvec" in steps or "enqueue_step" in steps
    # the df passes' own grid cap, reached by both builds of each kernel
    assert f"__launch_bounds__(kThreads, kDFPersistentBlocksPerSM)\n{kernel}(" \
        in code


#: the shared routines that read a vector through a trailing ``load``
#: argument, and the arguments a call passes when it names the load
_LOADED = {"kkt_node_row": 6, "fold_partials": 5, "df_kkt_node_row": 8,
           "df_fold_partials": 5}


def _call_args(code: str, name: str):
    """The argument lists of each call of ``name`` (template arguments
    allowed) in ``code``, split at their top-level commas."""
    calls = []
    for hit in re.finditer(rf"(?<![\w.]){name}\s*(<[^()]*?>)?\(", code):
        depth, i, start = 1, hit.end(), hit.end()
        args, braces = [], 0
        while depth:
            c = code[i]
            if c in "({[":
                depth += c == "("
                braces += c != "("
            elif c in ")}]":
                depth -= c == ")"
                braces -= c != ")"
            if (c == "," and depth == 1 and braces == 0) or depth == 0:
                args.append(code[start:i].strip())
                start = i + 1
            i += 1
        calls.append(args)
    return calls


@pytest.mark.parametrize("src,kernel", [
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel"),
    ("lanczos_pass_two.cu", "pass_two_persistent_kernel"),
    ("df_lanczos_pass_one.cu", "df_pass_one_persistent_kernel"),
    ("df_lanczos_pass_two.cu", "df_pass_two_persistent_kernel")])
def test_no_read_only_load_reaches_a_vector_written_in_the_launch(src,
                                                                  kernel):
    # a persistent pass reads vectors that other blocks wrote earlier in the
    # launch (v, w, x, the dot partials): never through __ldg or a default
    # (direct) load, which may take the read-only path and see stale data
    body = _kernel_body(_code(CSRC / src), kernel)
    assert "__ldg" not in body and "DirectLoad" not in body
    called = 0
    for name, nargs in _LOADED.items():
        for args in _call_args(body, name):
            called += 1
            assert len(args) == nargs, (name, args)  # the load is named
            assert re.search(r"\b(ld|ld2|vld)$|Load\{", args[-1]), args
    assert called >= 1
    # the routines read through their load only, and the loads a pass
    # names are ld.global.ca
    common = "".join(_code(CSRC / f) for f in (
        "lanczos_common.cuh", "df_common.cuh", "lanczos_persistent.cuh",
        "lanczos_pass_one.cu"))
    for name in _LOADED:
        routine = common[re.search(rf"__forceinline__ \w+ {name}\(",
                                   common).start():]
        routine = routine[:routine.index("\n}\n")]
        assert "__ldg" not in routine and "load(" in routine, name
    for loader in ("CachedLoad", "ScaledLoad", "DFCachedLoad",
                   "DFScaledLoad"):
        struct = common[common.index(f"struct {loader} {{"):]
        struct = struct[:struct.index("\n};")]
        assert "__ldca(" in struct and "__ldg" not in struct, loader


@pytest.mark.parametrize("src,kernel,reduce", [
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel", "reduce_phase"),
    ("df_lanczos_pass_one.cu", "df_pass_one_persistent_kernel",
     "df_reduce_phase")])
def test_start_partials_avoid_the_first_dots_plane(src, kernel, reduce):
    # ||b||^2's partials and the first dot's (<v, w>, stored before the
    # step's first barrier) lie in different planes: no grid barrier
    # separates the fold of ||b||^2 from step 0's first stores, so a block
    # that folds late must not find them overwritten; the beta dot, stored
    # after a barrier, shares ||b||^2's plane
    body = _kernel_body(_code(CSRC / src), kernel)
    planes = [args[2] for args in _call_args(body, reduce)]
    start, first_dot, beta_dot = planes
    assert start != first_dot and start == beta_dot
    fold = re.search(rf"fold_partials(<\w+>)?\({start},", body)
    assert fold and fold.start() < body.index("for (int j")


@pytest.mark.parametrize("entry,has,lacks", [
    ("tpl_df_lanczos_pass_one", ["long long* clock", "int* flags",
                                 "float* w2", "float* partials"],
     ["scal"]),
    ("tpl_df_lanczos_pass_one_steps", ["float* scal", "int* flags",
                                       "float* w2"], ["clock"]),
    ("tpl_df_lanczos_pass_two", ["long long* clock"], ["w2"]),
    ("tpl_df_lanczos_pass_two_steps", ["float* w2"], ["clock"])])
def test_df_pass_signatures_name_each_routes_scratch(entry, has, lacks):
    # K9/K10 take the timer's clock and their own scratch; the per-step
    # references keep the parent's arguments (pass one's scalars, pass
    # two's w)
    _, decls = ENTRIES[entry]
    for decl in has:
        assert decl in decls, (entry, decl)
    for word in lacks:
        assert not any(word in d for d in decls), (entry, word)
    assert decls[-2:] == ["int* matvec_launches", "cudaStream_t stream"]


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["per_step", "persistent"])
def test_df_pass_one_scratch_is_what_the_entry_point_needs(persistent):
    # df_lanczos_pass_one.cu: K9's w2 (2 x 2 x n), partials (4 *
    # kMaxPartials), flags (1 + p); the per-step launches' w2 (2 x n),
    # partials (2 * kMaxPartials), scal (6), flags (1)
    lay = FusedKKTSolver(*random_kkt(np.random.default_rng(0)),
                         device=CPU).layout
    sc = DFPassOneScratch.alloc(lay, persistent)
    if persistent:
        assert tuple(sc.w2.shape) == (2, 2, lay.n)
        assert tuple(sc.partials.shape) == (4 * MAX_PARTIALS,)
        assert tuple(sc.flags.shape) == (1 + lay.p,) and sc.scal is None
    else:
        assert tuple(sc.w2.shape) == (2, lay.n)
        assert tuple(sc.partials.shape) == (2 * MAX_PARTIALS,)
        assert tuple(sc.flags.shape) == (1,)
        assert tuple(sc.scal.shape) == (6,)
    assert sc.flags.dtype == np.int32 or str(sc.flags.dtype) == "torch.int32"
    text = (CSRC / "df_lanczos_pass_one.cu").read_text()
    assert "w2 (2 x 2 x n: two halves)" in text
    assert "partials (4 * tpl::kMaxPartials" in text
    assert "flags (1 + p ints)" in text


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
    ("lanczos_pass_two.cu", "pass_two_persistent_kernel", "lanczos_pass_two"),
    ("df_lanczos_pass_one.cu", "df_pass_one_persistent_kernel",
     "df_lanczos_pass_one"),
    ("df_lanczos_pass_two.cu", "df_pass_two_persistent_kernel",
     "df_lanczos_pass_two")])
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
