"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every ``csrc/*.cu`` into ONE shared library with a plain C
interface, at first use, and ``ctypes`` loads it. The library lands in
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every exported C entry point; all return cudaError_t as int
_SIGNATURES = {
    # d, u, v, ptr, ent, m, p, x, y, stream
    "tpl_kkt_matvec": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # d, u, v, ptr, ent, m, p, b, k, tol, ztol, alphas, betas, bnorm, steps,
    # v_prev, v_curr, w, partials, scal, flags, *matvec_launches, stream
    "tpl_lanczos_pass_one": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _F,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             ctypes.POINTER(_I), _P],
    # d, u, v, ptr, ent, m, p, b, k, ztol, alphas, betas, y, nf, bnorm,
    # steps, x, v_prev, v_curr, w, *matvec_launches, stream
    "tpl_lanczos_pass_two": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _F,
                             _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {LIB_NAME}:\n"
            f"{proc.stderr[-4000:]}")
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
