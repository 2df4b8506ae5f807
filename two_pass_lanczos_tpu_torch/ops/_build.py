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
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "build_log", "NVCC_FLAGS"]

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
# argtypes of every exported C entry point; all return cudaError_t as int
# the arguments every pass-one entry point starts with (csrc/
# lanczos_pass_one.cu): d, u, v, ptr, ent, m, p, b, k, tol, ztol, comp,
# alphas, betas, bnorm, steps, v_prev, v_curr, w, partials, scal, flags
_PASS_ONE = [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F, _I,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
_SIGNATURES = {
    # d, u, v, ptr, ent, m, p, x, y, stream (f32 and f64 instances)
    "tpl_kkt_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "tpl_kkt_matvec_f64": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # *_PASS_ONE, *matvec_launches, stream
    "tpl_lanczos_pass_one": [*_PASS_ONE, ctypes.POINTER(_I), _P],
    # *_PASS_ONE, basis, *matvec_launches, stream
    "tpl_lanczos_pass_one_basis": [*_PASS_ONE, _P, ctypes.POINTER(_I), _P],
    # *_PASS_ONE, j0, count, *matvec_launches, stream
    "tpl_lanczos_pass_one_chunk": [*_PASS_ONE, _I, _I, ctypes.POINTER(_I),
                                   _P],
    # d, u, v, ptr, ent, m, p, b, k, ztol, alphas, betas, y, nf, bnorm,
    # steps, x, v_prev, v_curr, w, *matvec_launches, stream
    "tpl_lanczos_pass_two": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                             _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             ctypes.POINTER(_I), _P],
    # a, b, n, out (6 x n), stream
    "tpl_eft_check": [_P, _P, _I, _P, _P],
    # the double-float kernels (csrc/df_*.cu): d2, u, v, ptr, ent, m, p, ...
    # ... x2, y2, stream
    "tpl_df_kkt_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # ... b2, k, tol, ztol, coeffs, bnorm2, steps, v_prev2, v_curr2, w2,
    # partials, scal, flags, *matvec_launches, stream
    "tpl_df_lanczos_pass_one": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.POINTER(_I), _P],
    # ... b2, k, ztol, coeffs, y2, bnorm2, steps, x2, v_prev2, v_curr2, w2,
    # *matvec_launches, stream
    "tpl_df_lanczos_pass_two": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                                _P, _P, _P, _P, _P, _P, _P, _P,
                                ctypes.POINTER(_I), _P],
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
                fn.restype = ctypes.c_int
            lib.tpl_error_string.argtypes = [_I]
            lib.tpl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) for the current sources."""
    cu, cuh = _sources()
    log = BUILD_ROOT / _key(cu + cuh) / "build.log"
    return log.read_text() if log.is_file() else ""
