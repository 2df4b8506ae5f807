"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every ``csrc/*.cu`` into ONE shared library with a plain C
interface, at first use, and ``ctypes`` loads it: one ``nvcc -c`` per source,
all started together, then one link. The library lands in
``build/torch_kernels/<hash>/`` at the repository root, keyed by a hash of
the sources and the flags, so an edited kernel is rebuilt and an unchanged
one is reused. A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain versions.

The flags never include ``--use_fast_math``: it makes ``1/β`` and ``sqrt``
approximate and flushes subnormals to zero, which breaks the bitwise
pass-one/pass-two replay and the ``1000·tiny`` zero-``b`` cut.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "build_log", "sass_digests", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libtpl_torch_kernels.so"
#: the one target architecture, named once for the compiles and the link
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: flags of every compile; the link takes ``-shared`` and ``ARCH_FLAGS``
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every exported C entry point; all but tpl_error_string
# return cudaError_t as int
# the arguments every pass-one entry point starts with (csrc/
# lanczos_pass_one.cu): d, u, v, ptr, ent, m, p, b, k, tol, ztol, alphas,
# betas, bnorm, steps, v_prev, v_curr, w, partials, scal, flags
_PASS_ONE = [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_SIGNATURES = {
    # d, u, v, ptr, ent, m, p, x, y, stream (f32 and f64 instances; the
    # block-row references of K1 and K8 take the same)
    "tpl_kkt_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "tpl_kkt_matvec_f64": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "tpl_kkt_matvec_blockrows": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "tpl_kkt_matvec_blockrows_f64": [_P, _P, _P, _P, _P, _I, _I, _P, _P,
                                     _P],
    # vals, cols, indptr, blocks, n_blocks, budget, x, y, stream (K15, one
    # instance a dtype)
    **{f"tpl_csr_spmv_{dt}": [_P, _P, _P, _P, _I, _I, _P, _P, _P]
       for dt in ("f32", "f64", "c64", "c128")},
    # one shard's layout (d, u, v, ptr, ent, m, p), e_scale, x, y, stream
    # (K7 and its block-row reference)
    "tpl_kkt_shard_matvec": [_P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P],
    "tpl_kkt_shard_matvec_blockrows": [_P, _P, _P, _P, _P, _I, _I, _F, _P,
                                       _P, _P],
    # the fused sharded step (csrc/kkt_shard_matvec.cu's step instances of
    # K7, csrc/shard_step.cu): one shard's layout, v_prev, v, w, s,
    # partials, state, stream
    "tpl_shard_step_one_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                                  _P, _P, _P],
    # ... layout, v_prev, v, v_next, s, alphas, betas, steps, y, nf, k,
    # step, x, stream
    "tpl_shard_step_two_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # g, ranks, m, p, v_prev, v, w, partials, parts, state, scal, stream
    "tpl_shard_step_node_fold": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                                 _P],
    # g, ranks, m, p, v, w, partials, state, k_limit, alpha, scal, stream
    "tpl_shard_step_orthogonalise": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                                     _P, _P],
    # m, p, w, partials, parts, scal, stream
    "tpl_shard_step_norm": [_I, _I, _P, _P, _I, _P, _P],
    # g, ranks, m, p, v_prev, v, w, basis_row, state, next_state, k_limit,
    # tol, beta, scal, stream
    "tpl_shard_step_advance": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                               _F, _P, _P, _P],
    # g, ranks, m, p, v_prev, v, v_next, alphas, betas, steps, y, nf, k,
    # step, x, stream
    "tpl_shard_step_two_nodes": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _P, _P],
    # *_PASS_ONE, comp, clock, *matvec_launches, stream
    "tpl_lanczos_pass_one": [*_PASS_ONE, _I, _P, ctypes.POINTER(_I), _P],
    # *_PASS_ONE, comp, basis, clock, *matvec_launches, stream
    "tpl_lanczos_pass_one_basis": [*_PASS_ONE, _I, _P, _P,
                                   ctypes.POINTER(_I), _P],
    # *_PASS_ONE, comp, j0, count, clock, *matvec_launches, stream
    "tpl_lanczos_pass_one_chunk": [*_PASS_ONE, _I, _I, _I, _P,
                                   ctypes.POINTER(_I), _P],
    # *_PASS_ONE, comp, basis, j0, count, *matvec_launches, stream (the
    # per-step launches: the reference of K2, K4, K5 and of K6)
    "tpl_lanczos_pass_one_steps": [*_PASS_ONE, _I, _P, _I, _I,
                                   ctypes.POINTER(_I), _P],
    # d, u, v, ptr, ent, m, p, b, k, ztol, alphas, betas, y, nf, bnorm,
    # steps, x, v_prev, v_curr, clock, *matvec_launches, stream
    "tpl_lanczos_pass_two": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                             _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             ctypes.POINTER(_I), _P],
    # the persistent passes' cooperative grids: (pass one's: comp,)
    # *blocks_per_sm, *sms
    "tpl_lanczos_pass_one_grid": [_I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I)],
    "tpl_lanczos_pass_one_basis_grid": [_I, ctypes.POINTER(_I),
                                        ctypes.POINTER(_I)],
    "tpl_lanczos_pass_one_chunk_grid": [_I, ctypes.POINTER(_I),
                                        ctypes.POINTER(_I)],
    "tpl_lanczos_pass_two_grid": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # a, b, n, out (6 x n), stream
    "tpl_eft_check": [_P, _P, _I, _P, _P],
    # stream (a launch of one empty block, K13's yardstick)
    "tpl_empty_launch": [_P],
    # the double-float kernels (csrc/df_*.cu): d2, u, v, ptr, ent, m, p, ...
    # ... x2, y2, stream
    "tpl_df_kkt_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # the same arguments, x and y as (hi, lo) pairs (the pair instance)
    "tpl_df_kkt_matvec_pairs": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # the same arguments over one shard's layout and local (hi, lo) pairs
    "tpl_df_kkt_shard_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # ... b2, k, tol, ztol, coeffs, bnorm2, steps, v_prev2, v_curr2, w2,
    # pairs, partials, flags, clock, *matvec_launches, stream (K9,
    # persistent)
    "tpl_df_lanczos_pass_one": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.POINTER(_I), _P],
    # ... b2, k, tol, ztol, coeffs, bnorm2, steps, v_prev2, v_curr2, w2,
    # partials, scal, flags, *matvec_launches, stream (the per-step launches)
    "tpl_df_lanczos_pass_one_steps": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                                      _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      ctypes.POINTER(_I), _P],
    # ... b2, k, ztol, coeffs, y2, bnorm2, steps, x2, v_prev2, v_curr2,
    # pairs, clock, *matvec_launches, stream (K10, persistent)
    "tpl_df_lanczos_pass_two": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.POINTER(_I), _P],
    # ... b2, k, ztol, coeffs, y2, bnorm2, steps, x2, v_prev2, v_curr2, w2,
    # *matvec_launches, stream (the per-step launches)
    "tpl_df_lanczos_pass_two_steps": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                                      _P, _P, _P, _P, _P, _P, _P, _P,
                                      ctypes.POINTER(_I), _P],
    # K9's and K10's cooperative grids: *blocks_per_sm, *sms
    "tpl_df_lanczos_pass_one_grid": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "tpl_df_lanczos_pass_two_grid": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    # the K14 probes (csrc/probe_*.cu): tab, ntab, idx, idx_type, hi, n,
    # head, quads, mode, cluster, slice_log2, clusters, g, stream
    "tpl_probe_gather": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P],
    # idx_type, two, mode, ntab, cluster, slice_log2, *active
    "tpl_probe_gather_clusters": [_I, _I, _I, _I, _I, _I,
                                  ctypes.POINTER(_I)],
    # d, u, v, x, rec, m, threads, arcs per thread, y, stream
    "tpl_probe_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # K7's arguments, then mode, param, stream
    "tpl_probe_stages": [_P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _I, _I,
                         _P],
    # K7's arguments, then mode, param, tile, stages, bulk, with_nodes,
    # arc_stream, node_stream
    "tpl_probe_pipeline": [_P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _I, _I,
                           _I, _I, _I, _I, _P, _P],
    # mode, tile, stages, bulk, *blocks_per_sm, *smem_bytes
    "tpl_probe_pipeline_blocks": [_I, _I, _I, _I, ctypes.POINTER(_I),
                                  ctypes.POINTER(_I)],
    # code (returns the message, a const char*)
    "tpl_error_string": [_I],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from csrc/ at first use and need the CUDA toolkit")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, sorted(CSRC.glob("*.cuh"))


def _key(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    cu, cuh = _sources()
    out_dir = BUILD_ROOT / _key(cu + cuh)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # a private object directory, so two processes may build at once
    obj = Path(tempfile.mkdtemp(dir=out_dir))
    objects = [str(obj / (src.stem + ".o")) for src in cu]
    compiles = []
    for src, o in zip(cu, objects):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-shared", *ARCH_FLAGS, "-o", tmp, *objects]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"link ({proc.returncode}):\n{proc.stdout[-4000:]}")
    shutil.rmtree(obj, ignore_errors=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed building {LIB_NAME}:\n"
                           + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p if name == "tpl_error_string"
                              else ctypes.c_int)
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) for the current sources."""
    cu, cuh = _sources()
    log = BUILD_ROOT / _key(cu + cuh) / "build.log"
    return log.read_text() if log.is_file() else ""


def sass_digests(lib=None) -> dict:
    """``{kernel: digest}`` of every kernel in a built library (the current
    sources' by default): the first 16 hex digits of the sha256 of its SASS
    as ``cuobjdump -sass`` prints it, so that two builds can be compared
    kernel by kernel. Only instruction and label lines count, and what
    depends on the build and not on the kernel is taken out: an anonymous
    namespace's name becomes ``{<file>_cu}`` (nvcc hashes the source's path
    into it), branch labels are numbered within each kernel (cuobjdump
    numbers them across the file), runs of blanks count as one (cuobjdump
    pads its columns to the file's widest line), and a call keeps its
    target's name but
    not its encoding (the offset to a subroutine the file's kernels share,
    such as the division's slow path, moves with the other kernels). Empty
    where the toolkit has no ``cuobjdump`` or it fails."""
    if lib is None:
        cu, cuh = _sources()
        lib = BUILD_ROOT / _key(cu + cuh) / LIB_NAME
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {}
    proc = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True)
    if proc.returncode:
        return {}
    text = proc.stdout
    out, name, body, call = {}, None, [], False

    def close():
        if name is not None:
            labels = {}
            text = re.sub(r"\.L_x_\d+", lambda hit: labels.setdefault(
                hit.group(0), f".L{len(labels)}"), "\n".join(body))
            out[name] = hashlib.sha256(text.encode()).hexdigest()[:16]

    for line in text.splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            close()
            name, body = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+_cu)_"
                                r"[0-9a-f]{8}", r"{\1}", func.group(1)), []
        elif name is not None and re.match(
                r"\s*(/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/|\.L_x_)", line):
            # instructions (and the second word of their encoding) and labels
            if call and line.lstrip().startswith("/* 0x"):
                call = False  # the call's second word
                continue
            call = " CALL" in line
            if call:
                line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)
            body.append(" ".join(line.split()))
    close()
    return out
