"""The port's C interface and CUDA sources, checked without a card.

``ops/_build._SIGNATURES`` gives ctypes the argument types of every
``extern "C"`` entry point of ``two_pass_lanczos_tpu_torch/csrc/*.cu``. An
entry point that is missing there, or has fewer or other types, makes ctypes
pass a 64-bit pointer as a 32-bit int: the kernel gets a cut address and no
error is raised. The sources must also keep the rules of bitwise replay: no
atomic reduction on a float and no fast-math build flag; and the persistent
passes (K2-K5 and the double-float K9, K10) launch cooperatively with no
fallback to per-step launches, read what the launch writes with no
read-only load, and get the scratch their C interfaces ask for (checked
through the wrappers against a stand-in for the library that records each
call); their phase timer stamps one time per phase that
``ops/kkt_fused.PHASES`` names.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu_torch import DFFusedKKTSolver
from two_pass_lanczos_tpu_torch.ops import _build, kkt_fused, kkt_fused_df
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    FusedKKTSolver,
    MAX_PARTIALS,
    PHASES,
    PassOneBuffers,
    pass_one_basis_cuda,
    pass_one_chunk_cuda,
    pass_one_cuda,
    pass_one_steps_cuda,
    reset_launches,
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
    # K2's parameters come from the TPL_PASS_ONE_ARGS macro: 21 of them,
    # then comp, the phase clock, the host counter and the stream
    _, decls = ENTRIES["tpl_lanczos_pass_one"]
    assert len(decls) == 25
    assert decls[0] == "const float *d" and decls[-1] == "cudaStream_t stream"
    assert [_kind(d) for d in decls[5:12]] == [
        "int", "int", "pointer", "int", "float", "float", "pointer"]
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


#: the persistent pass-one entry points: K2, K4 and K5
PASS_ONE_ENTRIES = {"K2": "tpl_lanczos_pass_one",
                    "K4": "tpl_lanczos_pass_one_basis",
                    "K5": "tpl_lanczos_pass_one_chunk"}


@pytest.mark.parametrize("kernel", sorted(PASS_ONE_ENTRIES))
def test_persistent_passes_launch_cooperatively_without_fallback(kernel):
    header = _code(CSRC / "lanczos_persistent.cuh")
    assert "cudaLaunchCooperativeKernel" in header
    assert "this_grid().sync()" in header
    assert "<<<" not in header
    # K3 has one launch, the cooperative one: no per-step kernels remain
    two = _code(CSRC / "lanczos_pass_two.cu")
    assert "<<<" not in two and "launch_kkt_matvec" not in two
    assert two.count("launch_persistent(") == 1
    # K2, K4 and K5 make one cooperative launch of their instance of the
    # persistent kernel, comp choosing the compensated one (K6), and return
    # its error as it is: none of them reaches the per-step launches
    one = _code(CSRC / "lanczos_pass_one.cu")
    body = _entry_body(one, PASS_ONE_ENTRIES[kernel])
    assert body.count("tpl::launch_pass_one(") == 1
    assert body.count("tpl::pass_one_instance<") == 1
    assert body.count("(comp)") == 1 and "tpl::run(" not in body
    assert "<<<" not in body and "enqueue_" not in body
    instance = _kernel_body(one, "PersistentKernel pass_one_instance")
    assert re.findall(r"pass_one_persistent_kernel<Basis, Resume, (\w+)>",
                      instance) == ["true", "false"]
    assert "tpl::run(" not in instance and "enqueue_" not in instance
    assert one.count("launch_persistent(") == 1
    launch = _kernel_body(one, "int launch_pass_one")
    assert "launch_persistent(" in launch and "tpl::run(" not in launch
    assert "return static_cast<int>(err)" in launch
    # the per-step launches (the reference, with either comp) have one door
    steps = _entry_body(one, "tpl_lanczos_pass_one_steps")
    assert "launch_persistent" not in steps
    assert "persistent_kernel" not in steps and "tpl::run(" in steps
    assert one.count("tpl::run(") == 1


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
_LOADED = {"kkt_node_row": 6, "kkt_node_row_warp": 5, "fold_partials": 5,
           "df_kkt_node_row": 6, "df_fold_partials": 5}


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
    if "pass_one" in kernel:
        # pass one's outputs and carried scalars (a resumed K5 chunk's live
        # flag, ||b|| and beta_prev) are read through ld as well: a
        # subscript of them is only ever a store
        for hit in re.finditer(r"\bs\.(flags|scal|bnorm2?|steps|alphas|"
                               r"betas|coeffs)\[[^\]]*\]\s*(=(?!=))?", body):
            assert hit.group(2), hit.group(0)
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
    # nor do the routines of the compensated reductions (K6's Comp
    # instances) read anything but their arguments
    for name in ("accumulate", "store_partial", "reduce_phase", "block_sum2",
                 "two_prod", "df_add2"):
        routine = common[re.search(rf"__forceinline__ \w+ {name}\(",
                                   common).start():]
        routine = routine[:routine.index("\n}\n")]
        assert "__ldg" not in routine and "DirectLoad" not in routine, name
    # every cached or scaled loader, of floats, of planes or of (hi, lo)
    # pairs: a pair written in the launch is never read through __ldg
    loaders = re.findall(r"struct (\w*(?:Cached|Scaled)Load) \{", common)
    assert {"CachedLoad", "ScaledLoad", "DFPairCachedLoad",
            "DFPairScaledLoad"} <= set(loaders)
    for loader in loaders:
        struct = common[common.index(f"struct {loader} {{"):]
        struct = struct[:struct.index("\n};")]
        assert "__ldca(" in struct and "__ldg" not in struct, loader
    # and a pair that the pass gathers or streams is read as one pair, never
    # through a planar loader, __ldg or the read-only direct loads
    if kernel.startswith("df_"):
        assert "DFDirectLoad" not in body and "DFPairDirectLoad" not in body
        assert "float2*" in body and "__ldca(" in body


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
    # nor the first dot's lo plane, where a partial is a (hi, lo) pair: the
    # compensated instances of K2, K4 and K5 (Comp) and K9
    for comp in (False, True):
        offset = {name: _plane_offset(body, name, comp)
                  for name in (start, first_dot)}
        pair = 2 if comp or src.startswith("df_") else 1
        assert offset[start] >= offset[first_dot] + pair, (comp, offset)
        assert offset[start] + pair <= 4  # the persistent scratch's planes


def _plane_offset(body: str, name: str, comp: bool) -> int:
    """The first plane of partials pointer ``name`` in a persistent pass
    one (``s.partials + c * kMaxPartials``), in planes, for an instance
    with or without Comp."""
    expr = re.search(rf"float\* const {name} = s\.partials([^;]*);",
                     body).group(1).strip()
    if not expr:
        return 0
    planes = re.fullmatch(r"\+ (\d+|\(Comp \? (\d+) : (\d+)\)) \* "
                          r"kMaxPartials", expr)
    assert planes, expr
    if planes.group(2):
        return int(planes.group(2) if comp else planes.group(3))
    return int(planes.group(1))


def test_comp_instances_compensate_every_reduction():
    # K6 is the Comp instances of the template: every reduction of the
    # kernel (the start's ||b||^2, <v, w>, <w, w> and their folds) is
    # instantiated on Comp, none on a fixed build, and a compensated block
    # partial is a (hi, lo) pair, lo at kMaxPartials + slot of the plane
    # pair the reduction names
    code = _code(CSRC / "lanczos_pass_one.cu")
    body = _kernel_body(code, "pass_one_persistent_kernel")
    assert "template <bool Basis, bool Resume, bool Comp>" in code
    assert "__shared__ float sl[Comp ? kThreads : 1];" in body
    for name, count in (("reduce_phase", 3), ("accumulate", 3),
                        ("fold_partials", 3)):
        calls = re.findall(rf"\b{name}(<\w+>)?\(", body)
        assert calls == ["<Comp>"] * count, (name, calls)
    for args in _call_args(body, "fold_partials"):
        assert args[3] == "sl", args  # the lo parts' shared array
    reduce = _kernel_body(code, "void reduce_phase")
    assert re.findall(r"store_partial(<\w+>)?\(", reduce) == ["<Comp>"]
    store = _kernel_body(code, "void store_partial")
    comp_branch = store[store.index("if constexpr (Comp)"):
                        store.index("} else {")]
    assert "partials[slot] = s.x;" in comp_branch
    assert "partials[kMaxPartials + slot] = s.y;" in comp_branch


@pytest.mark.parametrize("entry", sorted(
    name for name, (src, _) in ENTRIES.items()
    if src == "lanczos_pass_one.cu"))
def test_only_the_per_step_entry_point_reaches_the_per_step_launches(entry):
    # K2, K4, K5 and their K6 instances launch the persistent kernel; the
    # per-step launches (tpl::run) are the reference's alone
    body = _entry_body(_code(CSRC / "lanczos_pass_one.cu"), entry)
    assert ("tpl::run(" in body) == (entry == "tpl_lanczos_pass_one_steps")


@pytest.mark.parametrize("entry,has,lacks", [
    ("tpl_df_lanczos_pass_one", ["long long* clock", "int* flags",
                                 "float* w2", "float* pairs",
                                 "float* partials"],
     ["scal"]),
    ("tpl_df_lanczos_pass_one_steps", ["float* scal", "int* flags",
                                       "float* w2"], ["clock", "pairs"]),
    ("tpl_df_lanczos_pass_two", ["long long* clock", "float* pairs"],
     ["w2"]),
    ("tpl_df_lanczos_pass_two_steps", ["float* w2"], ["clock", "pairs"])])
def test_df_pass_signatures_name_each_routes_scratch(entry, has, lacks):
    # K9/K10 take the timer's clock and their own scratch, their vectors as
    # (hi, lo) pairs among it; the per-step references keep the parent's
    # arguments (pass one's scalars, pass two's w) and planes
    _, decls = ENTRIES[entry]
    for decl in has:
        assert decl in decls, (entry, decl)
    for word in lacks:
        assert not any(word in d for d in decls), (entry, word)
    assert decls[-2:] == ["int* matvec_launches", "cudaStream_t stream"]


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["per_step", "persistent"])
def test_df_pass_one_scratch_is_what_the_entry_point_needs(persistent):
    # df_lanczos_pass_one.cu: K9's w2 (2 x n pairs), pairs (2 x n pairs:
    # v_prev, v_curr), partials (4 * kMaxPartials), flags (1 + p); the
    # per-step launches' w2 (2 x n), partials (2 * kMaxPartials), scal (6),
    # flags (1)
    lay = FusedKKTSolver(*random_kkt(np.random.default_rng(0)),
                         device=CPU).layout
    sc = DFPassOneScratch.alloc(lay, persistent)
    if persistent:
        assert tuple(sc.w2.shape) == (2, lay.n, 2)
        assert tuple(sc.pairs.shape) == (2, lay.n, 2)
        assert tuple(sc.partials.shape) == (4 * MAX_PARTIALS,)
        assert tuple(sc.flags.shape) == (1 + lay.p,) and sc.scal is None
    else:
        assert tuple(sc.w2.shape) == (2, lay.n) and sc.pairs is None
        assert tuple(sc.partials.shape) == (2 * MAX_PARTIALS,)
        assert tuple(sc.flags.shape) == (1,)
        assert tuple(sc.scal.shape) == (6,)
    assert sc.flags.dtype == np.int32 or str(sc.flags.dtype) == "torch.int32"
    # the entry point's comment, its line breaks and comment marks dropped
    text = " ".join((CSRC / "df_lanczos_pass_one.cu").read_text()
                    .replace("//", " ").split())
    assert "w2 (2 x n pairs: two halves)" in text
    assert "pairs (2 x n pairs: v_prev, v_curr)" in text
    assert "partials (4 * tpl::kMaxPartials" in text
    assert "flags (1 + p ints)" in text


#: the pair loaders of df_common.cuh and the load each issues per entry
_PAIR_LOADERS = {"DFPairDirectLoad": "__ldg", "DFPairCachedLoad": "__ldca",
                 "DFPairScaledLoad": "__ldca"}


@pytest.mark.parametrize("loader", sorted(_PAIR_LOADERS))
def test_a_pair_loader_reads_an_entry_with_one_float2_load(loader):
    # an entry of a (hi, lo) pair vector is one 8-byte load of a const
    # float2*, never the two planes' 4-byte loads
    common = _code(CSRC / "df_common.cuh")
    struct = common[common.index(f"struct {loader} {{"):]
    struct = struct[:struct.index("\n};")]
    assert "const float2* x;" in struct
    loads = re.findall(r"\b(__ldg|__ldca|__ldcs|__ldcg)\(([^)]*)\)", struct)
    assert loads == [(_PAIR_LOADERS[loader], "x + i")]
    assert "xh" not in struct and "xl" not in struct


def _pair_node_rows():
    """(where, the load argument) of every df_kkt_node_row call on pairs:
    the pair K11's and K12's block and the persistent K9 and K10."""
    common = _code(CSRC / "df_common.cuh")
    found = [("df_kkt_pair_block", args[-1]) for args in _call_args(
        _kernel_body(common, "void df_kkt_pair_block"), "df_kkt_node_row")]
    for src, kernel in (("df_lanczos_pass_one.cu",
                         "df_pass_one_persistent_kernel"),
                        ("df_lanczos_pass_two.cu",
                         "df_pass_two_persistent_kernel")):
        body = _kernel_body(_code(CSRC / src), kernel)
        for args in _call_args(body, "df_kkt_node_row"):
            load = args[-1]
            if not load.startswith("DF"):  # a named loader: its declaration
                load = re.search(rf"const (\w+) {load}\{{", body).group(1)
            found.append((kernel, load))
    return found


def test_every_pair_node_row_loads_an_entry_with_one_float2_load():
    # every instance of df_kkt_node_row on the pair layout reads x_a
    # through a pair loader (one float2 load an entry, above), and so do
    # the arc rows' gathers of x_n beside it
    rows = _pair_node_rows()
    assert {where for where, _ in rows} == {
        "df_kkt_pair_block", "df_pass_one_persistent_kernel",
        "df_pass_two_persistent_kernel"}
    for where, load in rows:
        assert re.match(r"DFPair(Direct|Cached|Scaled)Load\b", load), (
            where, load)
    common = _code(CSRC / "df_common.cuh")
    block = _kernel_body(common, "void df_kkt_pair_block")
    for name in ("xj", "gu", "gv"):
        assert re.search(rf"const float2 {name} = __ldg\(x \+ ", block)
    for src, kernel in (("df_lanczos_pass_one.cu",
                         "df_pass_one_persistent_kernel"),
                        ("df_lanczos_pass_two.cu",
                         "df_pass_two_persistent_kernel")):
        body = _kernel_body(_code(CSRC / src), kernel)
        for name in ("gu", "gv"):
            assert re.search(rf"const float2 {name} = vld\(m \+ s\.[uv]",
                             body)


@pytest.mark.parametrize("src,entry", [
    ("df_lanczos_pass_one.cu", "tpl_df_lanczos_pass_one_steps"),
    ("df_lanczos_pass_two.cu", "tpl_df_lanczos_pass_two_steps")])
def test_df_per_step_references_reach_only_the_planar_instances(src, entry):
    # the per-step references stay on the planes: their launches are the
    # planar K11 (with its gate) and their own planar kernels, and no pair
    # instance or float2 vector reaches them
    code = _code(CSRC / src)
    body = _entry_body(code, entry)
    reached = body
    if "enqueue_step" in body:
        reached += _kernel_body(code, "cudaError_t enqueue_start")
        reached += _kernel_body(code, "cudaError_t enqueue_step")
    assert "launch_df_kkt_matvec(" in reached
    assert "_pairs" not in reached and "float2*" not in reached
    for kernel in re.findall(r"(\w+_kernel)<<<", reached):
        head = code[code.index(f"{kernel}("):]
        assert "float2" not in head[:head.index(")")], kernel
    # the planar K11 they launch reads x through the planes
    k11 = _code(CSRC / "df_kkt_matvec.cu")
    planar = _kernel_body(k11, "df_kkt_matvec_kernel")
    assert "DFDirectLoad{xh, xl}" in planar and "float2*" not in planar[
        :planar.index("{")]
    launch = _kernel_body(k11, "cudaError_t launch_df_kkt_matvec")
    assert "df_kkt_matvec_kernel<<<" in launch and "_pairs" not in launch


class _DFRecordingLibrary:
    """Stands in for the kernel library for the df wrappers on the CPU:
    records each call with its ctypes arguments and leaves the matvec
    count the card would (k for pass one, k - 1 for pass two)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            if entry.startswith("tpl_df_lanczos_pass_"):
                k = args[8]
                args[-2]._obj.value = k if "_one" in entry else k - 1
            return 0
        return call


#: the df routes, by the entry point each wrapper calls
_DF_ROUTES = {"pair_k11": "tpl_df_kkt_matvec_pairs",
              "k12": "tpl_df_kkt_shard_matvec",
              "k9": "tpl_df_lanczos_pass_one",
              "k9_steps": "tpl_df_lanczos_pass_one_steps",
              "k10": "tpl_df_lanczos_pass_two",
              "k10_steps": "tpl_df_lanczos_pass_two_steps"}


@pytest.mark.parametrize("route", sorted(_DF_ROUTES))
def test_df_wrappers_hand_each_entry_point_its_layout(monkeypatch, route):
    # the pair K11 and K12 take (n, 2) pairs and return them; K9 and K10
    # get their pair scratch (w's halves and v_prev, v_curr: (2, n, 2);
    # K10's v_prev, v_curr and x: (3, n, 2)) beside the caller's planar b,
    # x and state; the per-step references get planes only. Checked with
    # the recording library in the CPU layout's place
    lib = _DFRecordingLibrary()
    monkeypatch.setattr(kkt_fused_df, "load_library", lambda: lib)
    monkeypatch.setattr(kkt_fused_df, "_stream",
                        lambda: ctypes.c_void_p(None))
    monkeypatch.setattr(kkt_fused_df, "_df_layout_args", lambda lay, d2: (
        *(kkt_fused._ptr(t) for t in (d2, lay.u, lay.v, lay.ptr, lay.ent)),
        lay.m, lay.p))
    made = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        made.append(empty(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(torch, "empty", recording_empty)
    d, u, v, p = random_kkt(np.random.default_rng(0))
    s = DFFusedKKTSolver(d.astype(np.float64), u, v, p, device=CPU)
    lay, n, k = s.layout, s.n, 6
    reset_launches()
    if route in ("pair_k11", "k12"):
        fn = (kkt_fused_df.df_kkt_matvec_pairs_cuda if route == "pair_k11"
              else kkt_fused_df.df_kkt_shard_matvec_cuda)
        x = torch.ones(n, 2)
        y = fn(lay, s.d2, x)
        [(entry, args)] = lib.calls
        assert entry == _DF_ROUTES[route] and tuple(y.shape) == (n, 2)
        assert (args[7].value, args[8].value) == (x.data_ptr(),
                                                  y.data_ptr())
        with pytest.raises(ValueError, match="x"):
            fn(lay, s.d2, torch.ones(2, n))  # the planes are refused
        name = {"pair_k11": "df_kkt_matvec_pairs",
                "k12": "df_kkt_streaming_matvec"}[route]
        assert {key: c for key, c in LAUNCHES.items() if c} == {name: 1}
        return
    b2 = torch.ones(2, n)
    steps = route.endswith("_steps")
    if route.startswith("k9"):
        fn = (kkt_fused_df.df_pass_one_steps_cuda if steps
              else kkt_fused_df.df_pass_one_cuda)
        fn(lay, s.d2, b2, k, s.tol, s.ztol)
        scratch = {16: (2, n) if steps else (2, n, 2),
                   17: (2 * MAX_PARTIALS,) if steps else (2, n, 2),
                   14: (2, 2, n)}
        pass_name, matvecs = "df_lanczos_pass_one", k
    else:
        z = torch.zeros(k)
        coeffs = (z, z, z, z, torch.ones(2),
                  torch.tensor([k], dtype=torch.int32))
        fn = (kkt_fused_df.df_pass_two_steps_cuda if steps
              else kkt_fused_df.df_pass_two_cuda)
        x2 = fn(lay, s.d2, b2, coeffs, torch.zeros(2, k), s.ztol)
        assert tuple(x2.shape) == (2, n)
        scratch = {17: (2, n) if steps else (3, n, 2), 15: (2, 2, n),
                   14: (2, n)}
        pass_name, matvecs = "df_lanczos_pass_two", k - 1
    [(entry, args)] = lib.calls
    assert entry == _DF_ROUTES[route]
    assert args[7].value == b2.data_ptr()
    shape_at = {t.data_ptr(): tuple(t.shape) for t in made}
    for i, shape in scratch.items():
        assert shape_at[args[i].value] == shape, (i, shape)
    got = {key: c for key, c in LAUNCHES.items() if c}
    assert got == ({pass_name + "_steps": 1, "df_kkt_matvec": matvecs}
                   if steps else
                   {pass_name: 1, "df_kkt_matvec_in_pass": matvecs})


_SASS = """
\t\tFunction : _ZN3tpl45_GLOBAL__N__{ns}_12_eft_check_cu_5c81709d16eft_check_kernelEv
        /*0000*/  LDC R1, c[0x0][0x28] ;{pad}/* 0x00000a00ff017b82 */
                  {pad}/* 0x000e220000000800 */
        /*0010*/  @P0 BRA `(.L_x_{label}) ;{pad}/* 0x0000000000007947 */
                  {pad}/* 0x000fea0003800000 */
.L_x_{label}:
        /*0020*/  CALL.REL.NOINC `(__internal_0_slowpath) ;{pad}/* 0x{call}007944 */
                  {pad}/* 0x000fea0003c{call2}0 */
        /*0030*/  EXIT ;{pad}/* 0x{exit}794d */
                  {pad}/* 0x000fea0003800000 */
\t\tFunction : _ZN3tpl17kkt_matvec_kernelIfEEvv
        /*0000*/  EXIT ;{pad}/* 0x000000000000794d */
"""


def test_sass_digests_ignore_what_the_build_moves(tmp_path, monkeypatch):
    # two builds of the same kernels differ in the source path hashed into
    # the anonymous namespace, the file-wide label numbers, the column
    # padding and the offset a call encodes to a shared subroutine: the
    # digests must not; a changed instruction must change its kernel's
    tool = tmp_path / "cuobjdump"
    tool.write_text('#!/bin/sh\ncat "$2"\n')
    tool.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    fields = dict(ns="57467b44", label=12, pad=" " * 8, call="0000001234",
                  call2="0000", exit="000000000000")
    digests = []
    for change in ({}, dict(ns="b3244c9d", label=40, pad=" " * 30,
                            call="0000009999", call2="1111"),
                   dict(exit="000000000001")):
        listing = tmp_path / f"listing{len(digests)}.txt"
        listing.write_text(_SASS.format(**{**fields, **change}))
        digests.append(_build.sass_digests(listing))
    same, moved, changed = digests
    assert sorted(same) == ["_ZN3tpl17kkt_matvec_kernelIfEEvv",
                            "_ZN3tpl{eft_check_cu}16eft_check_kernelEv"]
    assert moved == same
    key = "_ZN3tpl{eft_check_cu}16eft_check_kernelEv"
    assert changed[key] != same[key]
    del changed[key], same[key]
    assert changed == same


class _RecordingLibrary:
    """Stands in for the kernel library on the CPU: records each pass-one
    call with its ctypes arguments and leaves behind what the card would
    for the host to read: the matvec count, and after a K5 chunk the steps
    done, the live flag and ||b|| (written at the pointers the wrapper
    passed, into CPU tensors)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            count = args[8]  # k
            if entry in ("tpl_lanczos_pass_one_chunk",
                         "tpl_lanczos_pass_one_steps"):
                # K5's chunk is followed by its clock
                at = -5 if entry == "tpl_lanczos_pass_one_chunk" else -4
                j0, count = args[at], args[at + 1]
                ctypes.c_float.from_address(args[13].value).value = 1.0
                ctypes.c_int.from_address(args[14].value).value = j0 + count
                ctypes.c_int.from_address(args[20].value).value = 1
            args[-2]._obj.value = count  # *matvec_launches
            return 0
        return call


@pytest.fixture
def recorded(monkeypatch):
    """The recording library (and no CUDA stream) in the wrappers' place,
    and every ``PassOneBuffers`` they allocate."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(kkt_fused, "load_library", lambda: lib)
    monkeypatch.setattr(kkt_fused, "_stream", lambda: ctypes.c_void_p(None))
    allocated = []
    alloc = PassOneBuffers.alloc.__func__

    def recording_alloc(cls, *args, **kwargs):
        allocated.append(alloc(cls, *args, **kwargs))
        return allocated[-1]

    monkeypatch.setattr(PassOneBuffers, "alloc", classmethod(recording_alloc))
    reset_launches()
    return lib, allocated


@pytest.mark.parametrize("kernel", sorted(PASS_ONE_ENTRIES))
@pytest.mark.parametrize("compensated", [True, False],
                         ids=["compensated", "persistent"])
def test_pass_one_scratch_is_what_the_entry_point_needs(
        recorded, monkeypatch, kernel, compensated):
    # lanczos_pass_one.cu: the persistent K2, K4 and K5 and their
    # compensated instances (K6: the same entry points with comp) take w
    # (2n), partials (4 planes: K6's two dots, a hi and a lo plane each) and
    # flags (1 + p). Each wrapper allocates that scratch, calls its entry
    # point with its comp and counts its matvecs as phases inside the
    # launch: no K1 launch on either route
    lib, allocated = recorded
    d, u, v, p = random_kkt(np.random.default_rng(0))
    solver = FusedKKTSolver(d, u, v, p, compensated=compensated, device=CPU)
    lay, k = solver.layout, 7
    b = torch.ones(lay.n)
    if kernel == "K2":
        pass_one_cuda(lay, b, k, solver.tol, solver.ztol,
                      compensated=compensated)
    elif kernel == "K4":
        _, basis = pass_one_basis_cuda(lay, b, k, solver.tol, solver.ztol,
                                       compensated=compensated)
        assert tuple(basis.shape) == (k, lay.n) and not basis.any()
    else:  # the solver's chunk loop, as on a card
        monkeypatch.setattr(FusedKKTSolver, "_cuda", property(lambda s: True))
        dec = solver.pass_one_chunked(b, k, chunk=3)
        # steps, the live flag (flags[:1]) and ||b|| come back in one copy
        assert dec.steps() == k and float(dec.b_norm) == 1.0
    entry = PASS_ONE_ENTRIES[kernel]
    assert [e for e, _ in lib.calls] == [entry] * (3 if kernel == "K5" else 1)
    for i, (_, args) in enumerate(lib.calls):
        assert args[21] == int(compensated)  # comp, then the route's own
        if kernel == "K4":
            assert args[22].value == basis.data_ptr()
        elif kernel == "K5":
            assert args[22:24] == (3 * i, min(3, k - 3 * i))
    for bufs in allocated:
        assert bufs.persistent
        assert tuple(bufs.w.shape) == (2, lay.n)
        assert tuple(bufs.partials.shape) == (4 * MAX_PARTIALS,)
        assert tuple(bufs.flags.shape) == (1 + lay.p,)
        assert tuple(bufs.state.shape) == (2, lay.n)
        assert bufs.alphas.shape == bufs.betas.shape == (k,)
    assert len(allocated) == 1
    name = ("lanczos_pass_one_comp" if compensated else
            {"K2": "lanczos_pass_one", "K4": "lanczos_pass_one_basis",
             "K5": "lanczos_pass_one_chunk"}[kernel])
    got = {key: c for key, c in LAUNCHES.items() if c}
    assert got == {name: len(lib.calls), "kkt_matvec_in_pass": k}
    text = " ".join(re.sub(r"//", " ", (CSRC / "lanczos_pass_one.cu")
                           .read_text()).split())
    assert "w (2n for the persistent K2, K4 and K5; n for the per-step" in text
    assert ("partials (4 * tpl::kMaxPartials for K2, K4 and K5, whose "
            "compensated instances use all four planes; 2 * "
            "tpl::kMaxPartials for the per-step launches)") in text
    assert "flags (1 + p ints for K2, K4 and K5; 1 for the per-step" in text


def test_per_step_reference_counts_its_own_launches(recorded):
    # the reference (tpl_lanczos_pass_one_steps) runs K5's chunks on the
    # per-step scratch (2 planes of partials), with K4's rows when a basis
    # is given, compensated (K6's reference) or not, and counts its K1
    # launches apart from the kernels it is the reference of
    lib, _ = recorded
    lay = FusedKKTSolver(*random_kkt(np.random.default_rng(0)),
                         device=CPU).layout
    bufs = PassOneBuffers.alloc(lay, 9)
    assert tuple(bufs.partials.shape) == (2 * MAX_PARTIALS,)
    basis = torch.zeros(9, lay.n)
    b = torch.ones(lay.n)
    pass_one_steps_cuda(lay, bufs, b, 0, 4, 1e-3, 1e-30)
    pass_one_steps_cuda(lay, bufs, b, 4, 5, 1e-3, 1e-30, basis=basis)
    pass_one_steps_cuda(lay, bufs, b, 0, 9, 1e-3, 1e-30, compensated=True)
    (e0, a0), (e1, a1), (e2, a2) = lib.calls
    assert e0 == e1 == e2 == "tpl_lanczos_pass_one_steps"
    assert a0[21] == a1[21] == 0 and a2[21] == 1  # comp
    assert a0[22].value is None and a0[23:25] == (0, 4)
    assert a1[22].value == basis.data_ptr() and a1[23:25] == (4, 5)
    got = {key: c for key, c in LAUNCHES.items() if c}
    assert got == {"lanczos_pass_one_steps": 3, "kkt_matvec": 18}
    with pytest.raises(ValueError, match="basis"):
        pass_one_steps_cuda(lay, bufs, b, 0, 9, 1e-3, 1e-30,
                            basis=torch.zeros(8, lay.n))


@pytest.mark.parametrize("route", ["chunk", "steps"])
def test_pass_one_wrappers_refuse_the_other_routes_scratch(route):
    # K5 runs on the persistent scratch and the reference on the per-step
    # one: given the other's, the wrapper raises before any launch
    lay = FusedKKTSolver(*random_kkt(np.random.default_rng(0)),
                         device=CPU).layout
    b = torch.ones(lay.n)
    if route == "chunk":
        bufs = PassOneBuffers.alloc(lay, 4)
        with pytest.raises(ValueError, match="persistent scratch"):
            pass_one_chunk_cuda(lay, bufs, b, 0, 4, 1e-3, 1e-30)
    else:
        bufs = PassOneBuffers.alloc(lay, 4, persistent=True)
        with pytest.raises(ValueError, match="per-step scratch"):
            pass_one_steps_cuda(lay, bufs, b, 0, 4, 1e-3, 1e-30)


@pytest.mark.parametrize("entry,has,lacks", [
    ("tpl_lanczos_pass_one", ["int comp", "long long* clock"],
     ["basis", "j0"]),
    ("tpl_lanczos_pass_one_basis", ["int comp", "float* basis",
                                    "long long* clock"], ["j0"]),
    ("tpl_lanczos_pass_one_chunk", ["int comp", "int j0", "int count",
                                    "long long* clock"], ["basis"]),
    ("tpl_lanczos_pass_one_steps", ["int comp", "float* basis", "int j0",
                                    "int count"], ["clock"])])
def test_pass_one_signatures_name_each_routes_arguments(entry, has, lacks):
    # every pass-one entry point takes comp (K6: the compensated instance);
    # the per-step entry point takes what K4 and K5 add (a basis, a chunk);
    # the persistent K2, K4 and K5 (each instance) take the phase timer's
    # clock, the per-step reference none
    _, decls = ENTRIES[entry]
    for decl in has:
        assert decl in decls, (entry, decl)
    for word in lacks:
        assert not any(word in d for d in decls), (entry, word)
    assert decls[-2:] == ["int* matvec_launches", "cudaStream_t stream"]


def test_basis_rows_stream_past_the_l2():
    # K4's rows (1 GB at k = 500) leave with st.global.cs, evict first, so
    # that they do not push the L2-resident working set out: every row store
    # of the persistent kernel is a __stcs, and K4's entry point and grid
    # name the one instance that makes them
    code = _code(CSRC / "lanczos_pass_one.cu")
    body = _kernel_body(code, "pass_one_persistent_kernel")
    stores = re.findall(r"if constexpr \(Basis\) (\w+)\((s\.basis|row) \+ i,",
                        body)
    assert len(stores) == 3 and {f for f, _ in stores} == {"__stcs"}
    assert "row[" not in body and "basis[" not in body
    for entry in ("tpl_lanczos_pass_one_basis",
                  "tpl_lanczos_pass_one_basis_grid"):
        assert "pass_one_instance<true, false>(comp)" in _entry_body(
            code, entry)


def _kernel_body(code: str, name: str) -> str:
    body = code[code.index(name + "("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("path,kernel,name,entry", [
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel", "lanczos_pass_one",
     "tpl_lanczos_pass_one"),
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel",
     "lanczos_pass_one_basis", "tpl_lanczos_pass_one_basis"),
    ("lanczos_pass_one.cu", "pass_one_persistent_kernel",
     "lanczos_pass_one_chunk", "tpl_lanczos_pass_one_chunk"),
    ("lanczos_pass_two.cu", "pass_two_persistent_kernel", "lanczos_pass_two",
     "tpl_lanczos_pass_two"),
    ("df_lanczos_pass_one.cu", "df_pass_one_persistent_kernel",
     "df_lanczos_pass_one", "tpl_df_lanczos_pass_one"),
    ("df_lanczos_pass_two.cu", "df_pass_two_persistent_kernel",
     "df_lanczos_pass_two", "tpl_df_lanczos_pass_two")],
    ids=["K2", "K4", "K5", "K3", "K9", "K10"])
def test_phase_timer_stamps_every_phase_once(path, kernel, name, entry):
    # a step stamps its start and the end of each phase of PHASES, in order
    # (the node rows of K2-K6 and K3, ended by each warp on its own, with
    # warp_stamp, and the next stamp writes the latest warp's end), and the
    # entry point sizes the clock for as many stamps: phase_split reads
    # stamp e + 1 - stamp e as phase e
    code = _code(CSRC / path)
    body = _kernel_body(code, kernel)
    stamps = [int(e) for e in re.findall(
        r"a\.clock\.(?:warp_)?stamp\(j, (\d+)[,)]", body)]
    assert stamps == list(range(len(PHASES[name]) + 1))
    assert f"PhaseClock{{clock, k / 2, {len(stamps)}}}" in _entry_body(
        code, entry)
    for warp in re.findall(r"a\.clock\.warp_stamp\(j, (\d+), (\w+)\)", body):
        # the stamp after a warp stamp folds the same warps' ends
        assert f"a.clock.stamp(j, {int(warp[0]) + 1}, {warp[1]})" in body
    # a null clock returns before the stamp's __syncthreads: a solve pays
    # one uniform branch a stamp; the warp stamp and its fold check it too
    header = _code(CSRC / "lanczos_persistent.cuh")
    stamp = _kernel_body(header, "void stamp")
    assert stamp.index("clock == nullptr") < stamp.index("__syncthreads")
    clock = header[header.index("struct PhaseClock {"):]
    clock = clock[:clock.index("\n};")]
    timed = clock[clock.index("bool timed("):]
    assert "clock != nullptr" in timed[:timed.index("}")]
    for method in ("void warp_stamp(", "const long long* ends) const {"):
        part = clock[clock.index(method):]
        part = part[:part.index("\n  }")]
        assert "if (!timed(j)) return;" in part
        assert ("__syncthreads" not in part) == (method == "void warp_stamp(")


def _routine(code: str, name: str) -> str:
    """The body of the device routine ``name`` in ``code``."""
    body = code[re.search(rf"__forceinline__ \w+ {name}\(", code).start():]
    return body[:body.index("\n}\n")]


def test_warp_row_needs_no_block_and_shuffles_the_whole_warp():
    # kkt_node_row_warp is one warp's: no barrier, no shared memory, no
    # atomic, so the block's other warps never wait for it; each tree level
    # past the registers is a shuffle of all 32 lanes (the row has them all)
    routine = _routine(_code(CSRC / "lanczos_common.cuh"),
                       "kkt_node_row_warp")
    for word in ("__syncthreads", "__shared__", "atomic", "block_sum",
                 "__syncwarp"):
        assert word not in routine, word
    shuffles = re.findall(r"__shfl\w*\(([^,]*),", routine)
    assert shuffles and set(shuffles) == {"0xffffffffu"}
    assert re.findall(r"__shfl(\w*)\(", routine) == ["_down_sync"]
    # the partials start at +0, walk 256 apart (kThreads) from the lane's
    # first entry and are added in the block row's pairs
    assert "ptr[node] + threadIdx.x % kLanes" in routine
    assert "q0 += kThreads" in routine
    assert "acc[r] = add_rn(acc[r], acc[r + s])" in routine
    assert "add_rn(acc[0], __shfl_down_sync(" in routine


#: each site of the node walk, the kernel that runs it and the routine its
#: rows go through
_WALK_SITES = {
    "K1/K8": ("kkt_matvec.cu", "kkt_matvec_kernel", "kkt_node_row_warp"),
    "K7": ("kkt_shard_matvec.cu", "kkt_shard_matvec_kernel",
           "kkt_node_row_warp"),
    "K2-K6": ("lanczos_pass_one.cu", "pass_one_persistent_kernel",
              "kkt_node_row_warp"),
    # K3 kept the block row: one warp a row was slower there
    "K3": ("lanczos_pass_two.cu", "pass_two_persistent_kernel",
           "kkt_node_row"),
}


@pytest.mark.parametrize("site", sorted(_WALK_SITES))
def test_each_site_runs_the_node_row_it_kept(site):
    # the solves' and operators' matvecs run the routine their site kept;
    # the block row is left to the references (the BlockRows instances)
    src, kernel, routine = _WALK_SITES[site]
    body = _kernel_body(_code(CSRC / src), kernel)
    rows = re.findall(r"\b(kkt_node_row(?:_warp)?)\s*\(", body)
    assert routine in rows
    if "BlockRows" in body:  # K1/K8 and K7 carry their reference
        main = body[body.index("} else {"):]
        assert re.findall(r"\b(kkt_node_row(?:_warp)?)\s*\(", main) == [
            routine]
    else:
        assert set(rows) == {routine}
        # pass one deals its rows to warps, K3 to blocks
        warps = routine == "kkt_node_row_warp"
        assert ("row_share(" in body) == warps
        assert ("share_of(s.p)" in body or "share_of(a.p)" in body) != warps


@pytest.mark.parametrize("entry,reaches", [
    ("tpl_kkt_matvec", "launch_kkt_matvec("),
    ("tpl_kkt_matvec_f64", "launch_kkt_matvec("),
    ("tpl_kkt_matvec_blockrows", "launch_rows<float, true>("),
    ("tpl_kkt_matvec_blockrows_f64", "launch_rows<double, true>("),
    ("tpl_kkt_shard_matvec", "launch<false>("),
    ("tpl_kkt_shard_matvec_blockrows", "launch<true>(")])
def test_reference_entry_points_reach_the_block_row(entry, reaches):
    # each reference entry point launches the BlockRows instance, whose node
    # blocks run kkt_node_row (one block a row, the node blocks after the
    # arc blocks); the other entry points launch the warp rows
    src, _ = ENTRIES[entry]
    code = _code(CSRC / src)
    assert reaches in _entry_body(code, entry)
    kernel = _kernel_body(code, "kkt_matvec_kernel" if src == "kkt_matvec.cu"
                          else "kkt_shard_matvec_kernel")
    reference = kernel[kernel.index("if constexpr (BlockRows) {"):
                       kernel.index("} else {")]
    assert re.findall(r"\b(kkt_node_row(?:_warp)?)\s*\(", reference) == [
        "kkt_node_row"]
    # the warp rows' node blocks come first; the reference keeps its
    # numbering, after the arc blocks
    assert "const bool first = !BlockRows;" in kernel
    if src == "kkt_matvec.cu":
        launch = _kernel_body(code, "cudaError_t launch_kkt_matvec")
        assert "launch_rows<T, false>(" in launch


@pytest.mark.parametrize("rows,blocks", [
    (1155, 528), (3651, 528), (5, 528), (4224, 528), (4225, 528),
    (300, 3)])
def test_row_share_deals_each_row_to_one_warp(rows, blocks):
    # pass one's row_share: warp at = block * 8 + warp of the grid's warps
    # takes rows [at * rows / warps, (at + 1) * rows / warps): every row to
    # exactly one warp, in order, the shares within one row of each other
    share = _routine(_code(CSRC / "lanczos_persistent.cuh"), "row_share")
    assert "blockIdx.x) * kWarps" in share
    assert "threadIdx.x / kWarpSize" in share
    assert "gridDim.x) * kWarps" in share
    assert "at * rows / warps" in share and "(at + 1) * rows / warps" in share
    warps = blocks * 8
    bounds = [(at * rows // warps, (at + 1) * rows // warps)
              for at in range(warps)]
    dealt = [r for lo, hi in bounds for r in range(lo, hi)]
    assert dealt == list(range(rows))
    sizes = {hi - lo for lo, hi in bounds}
    assert max(sizes) - min(sizes) <= 1


# --- K14a and K14c, the redesigned probes -----------------------------------

def _enum(code: str, name: str) -> dict:
    """The members of C enum ``name`` in ``code`` and their values."""
    body = code[code.index(f"enum {name} {{"):]
    body = body[body.index("{") + 1:body.index("};")]
    return {k: int(v) for k, v in re.findall(r"(\w+)\s*=\s*(\d+)", body)}


#: the stage probe's modes (probes/stages.MODES) and their enum members
_STAGE_MEMBERS = {"full": "kFull", "arc_only": "kArcOnly",
                  "node_only": "kNodeOnly", "node_no_gather": "kNodeNoGather",
                  "no_gather": "kNoGather", "stream_only": "kStreamOnly",
                  "alu": "kAlu", "gather": "kGather",
                  "node_sorted": "kNodeSorted"}


@pytest.mark.parametrize("mode", sorted(_STAGE_MEMBERS))
def test_each_stage_is_an_instance_the_entry_point_dispatches(mode):
    # the Python mode's number is the enum member's, and the entry point
    # launches that member's own instance of the kernel
    from two_pass_lanczos_tpu_torch.probes.stages import MODES
    code = _code(CSRC / "probe_stages.cu")
    member = _STAGE_MEMBERS[mode]
    assert _enum(code, "StagesMode")[member] == MODES[mode]
    entry = _entry_body(code, "tpl_probe_stages")
    assert re.search(rf"TPL_STAGE\({member}\);", entry)
    assert "return tpl::launch<tpl::M>(" in code
    assert set(MODES) == set(_STAGE_MEMBERS)


def test_stage_instances_run_k7s_routines_in_k7s_block_order():
    # every stage runs K7's warp rows and K7's arc row, never the block row;
    # the node blocks are numbered first; the stage is a template argument,
    # so no thread branches on it at run time
    code = _code(CSRC / "probe_stages.cu")
    kernel = _kernel_body(code, "probe_stages_kernel")
    assert "template <int Mode>" in code[:code.index("probe_stages_kernel(")]
    rows = re.findall(r"\b(kkt_node_row(?:_warp)?|kkt_arc_row)\s*\(", kernel)
    assert set(rows) == {"kkt_node_row_warp", "kkt_arc_row"}
    for word in ("block_sum", "__syncthreads", "__shared__", "switch"):
        assert word not in kernel, word
    assert not re.search(r"\bmode\b", kernel)
    branches = re.findall(r"\bif\s*(constexpr\s*)?\(([^)]*)", kernel)
    assert all(c or "Mode" not in cond for c, cond in branches)
    # K7's block order and row numbering
    assert "if (b >= node_blocks)" in kernel
    assert "(b - node_blocks) * kThreads + threadIdx.x" in kernel
    assert "b * kWarps + threadIdx.x / kWarpSize" in kernel
    k7 = _kernel_body(_code(CSRC / "kkt_shard_matvec.cu"),
                      "kkt_shard_matvec_kernel")
    arc = ("kkt_arc_row(d[j], x[j], __fmul_rn(e, __ldg(xn + u[j])),\n"
           "                         __fmul_rn(e, __ldg(xn + v[j])))")
    assert arc in k7
    assert "__fmul_rn(e, __ldg(xn + uj))" in kernel
    assert "y[m + node] = __fmul_rn(e, total)" in kernel
    launch = _kernel_body(code, "int launch")
    assert "(p + kWarps - 1) / kWarps" in launch
    assert "<<<node_blocks + arc_blocks, kThreads, 0, stream>>>" in launch


def test_gather_modes_match_the_kernels():
    import importlib
    g = importlib.import_module("two_pass_lanczos_tpu_torch.probes.gather")
    code = _code(CSRC / "probe_gather.cu")
    members = _enum(code, "GatherMode")
    assert [members[k] for k in ("kGatherSmem", "kGatherLdg", "kGatherPlain",
                                 "kGatherCluster", "kGatherClusterStage")] \
        == [g.MODES["smem"], g.MODES["ldg"], g.MODES["plain"],
            g.MODES["cluster"], g._KERNEL_MODES[g.STAGE_ONLY]]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", code)[1])
    assert const("kSmemBytes") == g.SMEM_BYTES
    assert const("kStageHeader") == g.STAGE_HEADER
    assert (const("kSmemBytes") - const("kStageHeader") - 16) // 4 \
        == g.SMEM_MAX_ENTRIES == 58_104
    assert const("kMaxCluster") == g.MAX_CLUSTER
    assert (const("kVec"), const("kUnroll")) == (g.VEC, g.UNROLL)


#: the bulk-copy and mbarrier helpers of probe_common.cuh (shared by K14a
#: and K14d) and the PTX each one issues
_BULK_HELPERS = {
    "mbar_init": "mbarrier.init.shared::cta.b64",
    "mbar_init_fence": "fence.mbarrier_init.release.cluster",
    "mbar_expect_tx": "mbarrier.arrive.expect_tx.shared::cta.b64",
    "mbar_arrive": "mbarrier.arrive.shared::cta.b64",
    "mbar_wait": "mbarrier.try_wait.parity.shared::cta.b64",
    "bulk_load": "cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes",
    "fence_proxy_async": "fence.proxy.async.shared::cta",
    "bulk_store": "cp.async.bulk.global.shared::cta.bulk_group",
    "bulk_commit": "cp.async.bulk.commit_group",
    "bulk_wait_read": "cp.async.bulk.wait_group.read",
    "bulk_wait": "cp.async.bulk.wait_group ",
}


@pytest.mark.parametrize("helper", sorted(_BULK_HELPERS))
def test_bulk_copy_helpers_issue_their_ptx_once(helper):
    body = _routine(_code(CSRC / "probe_common.cuh"), helper)
    assert body.count(_BULK_HELPERS[helper]) == 1
    others = [p for h, p in _BULK_HELPERS.items()
              if h != helper and p not in _BULK_HELPERS[helper]]
    assert not any(p in body for p in others), helper


def test_gather_stages_by_bulk_copy_on_an_mbarrier():
    # the smem and cluster tiers stage with one bulk copy completing an
    # mbarrier's phase (initialised, fenced, waited on by parity), not by a
    # thread loop over the table; the PTX lives in probe_common.cuh's
    # helpers, which K14d shares
    code = _code(CSRC / "probe_gather.cu")
    stage = _kernel_body(code, "float* stage_slice")
    for helper in ("mbar_init", "mbar_init_fence", "mbar_expect_tx",
                   "bulk_load", "mbar_wait"):
        assert len(re.findall(rf"\b{helper}\(", stage)) == 1, helper
    assert "asm" not in stage and "cp.async.bulk" not in code
    assert stage.index("mbar_init(") < stage.index("__syncthreads()") \
        < stage.index("mbar_expect_tx(")
    assert "mbar_wait(bar, 0)" in stage
    assert "i < count - body" in stage  # the threads copy the ragged ends
    kernel = _kernel_body(code, "probe_gather_kernel")
    assert kernel.count("stage_slice(") == 2
    assert "i < ntab" not in kernel and "stab[i] = tab[i]" not in kernel
    # the vector body: a quad's indices in one load, a 16-byte store
    assert "__ldcs(reinterpret_cast<const typename QuadOf<I>::T*>(p))" \
        in code
    assert "__stcs(reinterpret_cast<float4*>(g + head" in kernel


def test_gather_cluster_launch_returns_its_error_without_fallback():
    # the cluster tiers launch with cudaLaunchKernelEx and a cluster
    # dimension, and return its error as it is; no <<< launch and no other
    # tier on that branch; the occupancy query is its own entry point
    code = _code(CSRC / "probe_gather.cu")
    launch = _kernel_body(code, "cudaError_t launch_gather")
    branch = launch[launch.index("if constexpr (clustered<kMode>())"):
                    launch.index("} else {")]
    assert "return cudaLaunchKernelEx(&cfg, kernel," in branch
    assert "<<<" not in branch and "resident_grid" not in branch
    assert "cudaLaunchAttributeClusterDimension" in code
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in code
    assert "cudaOccupancyMaxActiveClusters(" in _kernel_body(
        code, "cudaError_t active_clusters")
    entry = _entry_body(code, "tpl_probe_gather")
    assert "return static_cast<int>(\n      tpl::dispatch_type(" in entry
    assert "cluster.sync()" in _kernel_body(code, "probe_gather_kernel")


@pytest.mark.parametrize("src", ["probe_gather.cu", "probe_stages.cu",
                                 "probe_pipeline.cu", "probe_common.cuh"])
def test_redesigned_probes_use_no_atomics(src):
    code = _code(CSRC / src)
    assert not re.search(r"\batomic\w*\s*\(", code)
    assert not re.search(r"\b(atom|red)(\.\w+)*\.\w+\b", code)
    assert "red.async" not in code and "cp.reduce" not in code


# --- K14d, the pipeline probe ----------------------------------------------

#: the pipeline probe's modes (probes/pipeline.MODES) and their members
_PIPELINE_MEMBERS = {"full": "kFull", "arc_only": "kArcOnly",
                     "no_gather": "kNoGather", "stream_only": "kStreamOnly",
                     "alu": "kAlu"}


@pytest.mark.parametrize("mode", sorted(_PIPELINE_MEMBERS))
def test_each_pipeline_mode_is_an_instance_the_entry_point_dispatches(mode):
    # the Python mode's number is the enum member's and the stage probe's
    # twin's; both entry points reach dispatch(), whose switch gives each
    # member its own instance, by tile, stages and store
    from two_pass_lanczos_tpu_torch.probes.pipeline import MODES
    code = _code(CSRC / "probe_pipeline.cu")
    member = _PIPELINE_MEMBERS[mode]
    assert _enum(code, "PipelineMode")[member] == MODES[mode]
    assert _enum(_code(CSRC / "probe_stages.cu"), "StagesMode")[member] \
        == MODES[mode]
    assert set(MODES) == set(_PIPELINE_MEMBERS)
    dispatch = _kernel_body(code, "cudaError_t dispatch")
    assert re.search(rf"TPL_PIPE\({member}\);", dispatch)
    assert "return by_tile<M>(tile, stages, bulk, c)" in dispatch
    for entry in ("tpl_probe_pipeline", "tpl_probe_pipeline_blocks"):
        assert "tpl::dispatch(mode, tile, stages, bulk, c)" in _entry_body(
            code, entry)
    for tile in (512, 1024, 2048):
        assert f"return by_stages<Mode, {tile}>(stages, bulk, c);" in code
    for stages in (2, 3, 4):
        assert f"return by_store<Mode, T, {stages}>(bulk, c);" in code


def test_pipeline_kernels_branch_on_no_mode_at_run_time():
    code = _code(CSRC / "probe_pipeline.cu")
    for kernel in ("probe_pipeline_arcs", "probe_pipeline_nodes"):
        body = _kernel_body(code, kernel)
        assert not re.search(r"\bmode\b", body), kernel
        assert "switch" not in body
        branches = re.findall(r"\bif\s*(constexpr\s*)?\(([^)]*)", body)
        assert all(c or "Mode" not in cond for c, cond in branches)


def test_pipeline_node_kernel_is_k7s_warp_rows_without_shared_memory():
    # ceil(p / 8) blocks of 8 warp rows, K7's routine and store, no block
    # row, no shared memory, no barrier; launched with no dynamic bytes,
    # before the arc kernel
    code = _code(CSRC / "probe_pipeline.cu")
    body = _kernel_body(code, "probe_pipeline_nodes")
    rows = re.findall(r"\b(kkt_node_row(?:_warp)?)\s*\(", body)
    assert rows and set(rows) == {"kkt_node_row_warp"}
    for word in ("__shared__", "__syncthreads", "block_sum", "extern"):
        assert word not in body, word
    assert "blockIdx.x * kWarps + threadIdx.x / kWarpSize" in body
    assert "y[m + node] = __fmul_rn(e, total)" in body
    assert "IndexAsValue{x}" in body
    run = _kernel_body(code, "cudaError_t run")
    assert "(c.p + kWarps - 1) / kWarps" in run
    assert "<<<node_blocks, kThreads, 0, c.node_stream>>>" in run
    assert run.index("probe_pipeline_nodes<") < run.index("arcs<<<")
    assert not re.search(r"\bkkt_node_row\s*\(", code)


def test_pipeline_arc_kernel_streams_through_bulk_copies_on_mbarriers():
    # a producer warp's elected lane waits for a stage's empty barrier,
    # arms its full barrier with expect_tx and bulk-copies d, u, v and x_a;
    # the consumer warps wait for the full barrier by parity, compute K7's
    # arc row and arrive on empty once a warp; no cp.async.cg or .ca left
    code = _code(CSRC / "probe_pipeline.cu")
    body = _kernel_body(code, "probe_pipeline_arcs")
    assert "cp.async.cg" not in code and "cp.async.ca" not in code
    assert "asm" not in body  # the PTX is probe_common.cuh's helpers'
    producer = body[body.index("if (threadIdx.x >= kConsumers) {"):
                    body.index("const int c = threadIdx.x;")]
    assert "if (threadIdx.x != kConsumers) return;" in producer
    assert producer.index("mbar_wait(empty + 8 * s, ((k / S) & 1) ^ 1)") \
        < producer.index("mbar_expect_tx(bar, kArrays * bytes)") \
        < producer.index("bulk_load(")
    assert len(re.findall(r"\bbulk_load\(", producer)) == 4
    for src in ("d + base", "u + base", "v + base", "x + base"):
        assert src in producer
    consumer = body[body.index("const int c = threadIdx.x;"):]
    assert "mbar_wait(full + 8 * s, (k / S) & 1)" in consumer
    assert "if (c % kWarpSize == 0) mbar_arrive(empty + 8 * s)" in consumer
    assert "mbar_init(empty + 8 * s, kConsumerWarps)" in body
    assert "mbar_init(full + 8 * s, 1)" in body
    assert body.index("mbar_init_fence()") < body.index("__syncthreads()")
    assert "tile += gridDim.x, ++k" in consumer
    # the tail words of a ragged tile come from global memory
    assert "const int body = count & ~3;" in consumer
    assert "staged ? slot[t] : d[j]" in consumer
    arc = _routine(code, "arc_row")
    assert ("kkt_arc_row(dj, xj, __fmul_rn(e, __ldg(xn + uj)),\n"
            "                           __fmul_rn(e, __ldg(xn + vj)))") in arc


def test_pipeline_bulk_store_is_fenced_and_waited_for():
    # store = bulk: every consumer fences its output-stage writes for the
    # async proxy, one thread waits until the stage's last store was read,
    # the consumers meet, then one bulk store of the tile's body; the
    # kernel ends after every store is done
    code = _code(CSRC / "probe_pipeline.cu")
    body = _kernel_body(code, "probe_pipeline_arcs")
    store = body[body.index("if constexpr (Bulk) {\n      fence_proxy_async"):]
    order = ["fence_proxy_async()", "bulk_wait_read<S - 2>()",
             "consumers_sync()", "bulk_store(y + base, ys, 4u * body)",
             "bulk_commit()"]
    at = [store.index(word) for word in order]
    assert at == sorted(at)
    assert body.count("bulk_store(") == 1
    assert "if (c == 0) bulk_wait<0>();" in body
    assert 'bar.sync 1, %0;" ::"n"(kConsumers)' in _routine(
        code, "consumers_sync")


def test_pipeline_returns_each_launchs_error():
    # the node launch's error is returned before the arc kernel launches;
    # the arc launch's is returned; no fallback to another launch
    code = _code(CSRC / "probe_pipeline.cu")
    run = _kernel_body(code, "cudaError_t run")
    launches = [m.end() for m in re.finditer(r">>>\([^;]*;", run)]
    assert len(launches) == 2
    for end in launches:
        assert run[end:].lstrip().startswith("err = cudaGetLastError();")
    assert "if (err != cudaSuccess) return err;" in run
    assert run.rstrip().endswith("return err;")
    assert "kkt_shard_matvec" not in code


# --- the fused arc-sharded step: K7's step instances, shard_step.cu ------

def _block_after(code: str, start: int) -> str:
    """The text from ``start`` to the end of the brace block opened
    first after it."""
    i, depth = code.index("{", start), 0
    for j in range(i, len(code)):
        depth += {"{": 1, "}": -1}.get(code[j], 0)
        if depth == 0:
            return code[start:j + 1]
    raise AssertionError("unbalanced braces")


def _step_parts() -> dict:
    """name -> code of each part of the fused sharded step: K7's step
    structs and their kernel template, and every kernel and device routine
    of ``shard_step.cu`` and ``shard_step.cuh``."""
    k7 = _code(CSRC / "kkt_shard_matvec.cu")
    parts = {name: _block_after(k7, k7.index(f"struct {name} {{"))
             for name in ("StepPassOne", "StepPassTwo")}
    parts["k7_step_kernel"] = _block_after(
        k7, k7.index("template <class Step>\n__global__"))
    for src in ("shard_step.cuh", "shard_step.cu"):
        code = _code(CSRC / src)
        for hit in re.finditer(
                r"__global__ void __launch_bounds__\(kThreads\)\s*(\w+)\("
                r"|__device__ __forceinline__ [^;{(]*?\b(\w+)\(", code):
            parts[hit.group(1) or hit.group(2)] = _block_after(code,
                                                               hit.start())
    return parts


STEP_PARTS = _step_parts()
#: every name the step's code declares as a float (a scalar, an array of
#: floats, a struct member) or as a pointer to floats
_STEP_CODE = "\n".join(STEP_PARTS.values()) + _code(CSRC / "shard_step.cuh")
_FLOATS = set(re.findall(r"\bfloat\s+(\w+)\s*[=;,\[)]", _STEP_CODE))
_FLOAT_PTRS = set(re.findall(
    r"\bfloat\s*\*\s*(?:const\s+)?(?:__restrict__\s+)?(\w+)", _STEP_CODE))


def _strip_brackets(text: str) -> str:
    while re.search(r"\[[^\[\]]*\]", text):
        text = re.sub(r"\[[^\[\]]*\]", "", text)
    return text


def _selected(rhs: str) -> str:
    """The values a right-hand side can take: both arms of a top-level
    ``cond ? a : b`` (the condition may compute indices), else itself."""
    depth = 0
    for i, c in enumerate(rhs):
        depth += {"(": 1, ")": -1}.get(c, 0)
        if c == "?" and depth == 0:
            return rhs[i + 1:]
    return rhs


def _assignments(code: str):
    """``(target, operator, right-hand side)`` of each assignment in
    ``code``; the target is the assigned name (a subscripted or
    dereferenced pointer's name, a member's name) and whether it was
    subscripted or dereferenced."""
    out = []
    for hit in re.finditer(r"(?<![=!<>+\-*/&|])([-+*/]?)=(?!=)", code):
        i = hit.start() - 1
        while code[i].isspace():
            i -= 1
        through = False
        while code[i] == "]":
            depth = 0
            while True:
                depth += {"]": 1, "[": -1}.get(code[i], 0)
                i -= 1
                if depth == 0:
                    break
            through = True
        j = i
        while code[j].isalnum() or code[j] == "_":
            j -= 1
        name = code[j + 1:i + 1]
        through = through or code[j] == "*" and not code[j - 1].isalnum()
        end = hit.end()
        depth = 0
        while not (depth == 0 and code[end] in ";,") and not (
                depth == 0 and code[end] == ")"):
            depth += {"(": 1, ")": -1}.get(code[end], 0)
            end += 1
        out.append((name, through, hit.group(1), code[hit.end():end]))
    return out


@pytest.mark.parametrize("part", sorted(STEP_PARTS))
def test_fused_step_rounds_every_float_update_through_the_rn_helpers(part):
    # every float the step computes is an *_rn helper's result (or a load,
    # a select, a constant): no bare + - * / that nvcc could contract into
    # an FMA, and no compound assignment, so pass two's regenerated vectors
    # round as pass one's; and no atomic
    code = STEP_PARTS[part]
    assert "atomic" not in code
    checked = 0
    for name, through, op, rhs in _assignments(code):
        is_float = (name in _FLOATS and not through) or (
            name in _FLOAT_PTRS and through) or (name in _FLOATS and through)
        if not is_float:
            continue
        checked += 1
        assert op == "", (part, name, op, rhs)
        bare = _strip_brackets(_selected(rhs)).replace("->", ".")
        assert not re.search(r"[-+*/]", bare), (part, name, rhs)
    assert checked or part in ("kkt_shard_matvec_kernel", "step_executes",
                               "slice_sum", "load_quad") or not re.search(
        r"\bfloat\b", code), part


def test_fused_step_spells_the_recurrence_with_the_shared_routines():
    # the vector updates are lanczos_common.cuh's, so they round as the
    # per-step and persistent passes and as the PyTorch scans do
    uses = {"StepPassOne": ["sub_scaled(", "mul_rn(", "block_sum("],
            "StepPassTwo": ["lanczos_update(", "normalise(", "add_rn(",
                            "mul_rn("],
            "pass_two_scalars": ["lanczos_inverse("],
            "shard_step_node_fold_kernel": ["sub_scaled(", "fold_ranks(",
                                            "block_sum("],
            "shard_step_orthogonalise_kernel": ["fold_dot(", "sub_scaled(",
                                                "block_sum("],
            "shard_step_advance_kernel": ["__fsqrt_rn(", "fold_dot(",
                                          "normalise(", "lanczos_inverse("],
            "shard_step_two_nodes_kernel": ["fold_ranks(", "lanczos_update(",
                                            "normalise(", "add_rn("]}
    for part, calls in uses.items():
        for call in calls:
            assert call in STEP_PARTS[part], (part, call)
    # K7's step instances are instances of K7 itself: the profiler's name
    # keeps kkt_shard_matvec_kernel, and the plain instance is untouched
    k7 = _code(CSRC / "kkt_shard_matvec.cu")
    assert "kkt_shard_matvec_kernel<Step>" in k7
    assert "kkt_shard_matvec_kernel<BlockRows>" in k7
    assert "tpl::launch<false>(" in _entry_body(k7, "tpl_kkt_shard_matvec")


def _params(code: str, kernel: str) -> dict:
    """name -> declaration of each parameter of ``kernel`` in ``code``."""
    head = code[code.index(kernel + "("):]
    head = head[len(kernel) + 1:head.index(")")]
    return {d.split()[-1].lstrip("*"): " ".join(d.split())
            for d in head.split(",")}


def test_fused_step_reads_no_vector_its_launch_writes_through_ldg():
    # shard_step.cu never takes the read-only path, and a vector a kernel
    # writes is a plain float* (no const, no __restrict__, which would let
    # nvcc load it through ld.global.nc); K7's step instances read through
    # __ldg only the node table of v, which no thread of the launch writes
    step = _code(CSRC / "shard_step.cu")
    assert "__ldg" not in step and "__ldg" not in _code(
        CSRC / "shard_step.cuh")
    kernels = re.findall(r"__global__ void __launch_bounds__\(kThreads\)\n"
                         r"(\w+)\(", step)
    assert len(kernels) == 5
    for kernel in kernels:
        body = STEP_PARTS[kernel][STEP_PARTS[kernel].index("{"):]
        params = _params(step, kernel)
        written = {name for name, through, _, _ in _assignments(body)
                   if through and name in params}
        written |= {args[0] for args in _call_args(body, "store_quad")}
        assert written, kernel
        for name in written:
            decl = params[name]
            assert "__restrict__" not in decl or "const" not in decl, decl
            read = (re.search(rf"\b{name}\[[^\]]*\](?!\s*=[^=])", body)
                    or any(args[0] == name
                           for args in _call_args(body, "load_quad")))
            if read:
                assert decl == f"float* {name}", (kernel, decl)
    k7 = "".join(STEP_PARTS[p] for p in ("StepPassOne", "StepPassTwo",
                                         "k7_step_kernel"))
    assert re.findall(r"__ldg\((&?\w+)", k7) == ["&xn", "&xn"]
    assert "const float* xn = x + m;" in STEP_PARTS["k7_step_kernel"]
    assert not re.search(r"\bx\[[^\]]*\]\s*=[^=]", k7)  # v is only read
    assert _call_args(k7, "kkt_node_row_warp") == [
        ["ptr", "ent", "x", "node"]]
