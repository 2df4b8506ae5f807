"""DIMACS ``.dmx`` / quadratic-cost ``.qfc`` parsers and KKT assembly inputs.

A copy of ``two_pass_lanczos_tpu/utils/data_loader.py`` (NumPy only; the
port imports nothing of the JAX package). Reference parity:
``src/utils/data_loader.rs`` — the same validation rules:

* ``.dmx``: a ``p min <nodes> <arcs>`` problem line is mandatory; comment
  (``c``) and node (``n``) lines are skipped; each ``a u v ...`` arc line
  contributes incidence entries ``E[u-1, j] = +1``, ``E[v-1, j] = -1``;
  indices are 1-based and an index of 0 is rejected
  (``data_loader.rs:91-134``).
* ``.qfc``: first token is the arc count m (validated against the ``.dmx``),
  followed by m fixed costs and m quadratic costs; only the quadratic costs
  are used (diagonal of D) (``data_loader.rs:158-198``).

**Format-ambiguity resolution**: the reference's Rust parser expects one
value per line, but the shipped ``qfcgen.c`` writes each cost list
space-separated on a single line (``data/qcnd/qfcgen.c:203-218``). Both
layouts are read by tokenizing: after the count, ``2m`` tokens ⇒ (fixed,
quadratic) lists in order, ``m`` tokens ⇒ quadratic only, anything else is
a hard error instead of a silent empty diagonal.

A C++ fast path (``cpp/dmx_parser.cpp``, built as ``cpp/libtpl_native.so``
and loaded with ctypes) parses large ``.dmx`` files; the pure-Python path
is the always-available fallback and the correctness oracle.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["DataLoaderError", "parse_dmx", "parse_qfc", "load_kkt_arrays", "KKTArrays"]


class DataLoaderError(Exception):
    """Parsing/validation failure (reference ``DataLoaderError``,
    ``src/utils/data_loader.rs:16-43``)."""


class KKTArrays(NamedTuple):
    """Raw arrays defining the KKT system ``A = [[D, Eᵀ], [E, 0]]``."""

    quad_costs: np.ndarray  # (m,) f64 — diagonal of D
    arc_u: np.ndarray  # (m,) int32, 0-based tail (E[u, j] = +1)
    arc_v: np.ndarray  # (m,) int32, 0-based head (E[v, j] = -1)
    num_nodes: int
    num_arcs: int

    @property
    def n(self) -> int:
        """KKT dimension: arcs + nodes (arc block first)."""
        return self.num_arcs + self.num_nodes


# ---------------------------------------------------------------------------
# Optional native fast path
# ---------------------------------------------------------------------------

_NATIVE = None


def _native_lib():
    """Load the optional C++ parser (cpp/libtpl_native.so) once."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE or None
    so = Path(__file__).resolve().parents[2] / "cpp" / "libtpl_native.so"
    if not so.exists():
        _NATIVE = False
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.tpl_parse_dmx.restype = ctypes.c_int64
        lib.tpl_parse_dmx.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),  # num_nodes out
            ctypes.POINTER(ctypes.c_int64),  # num_arcs out
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),  # u out
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),  # v out
        ]
        lib.tpl_free.argtypes = [ctypes.c_void_p]
        _NATIVE = lib
        return lib
    except OSError:
        _NATIVE = False
        return None


def parse_dmx(path) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Parse a DIMACS min-cost-flow file.

    Returns ``(num_nodes, num_arcs, arc_u, arc_v)`` with 0-based int32
    endpoint arrays. Raises :class:`DataLoaderError` on a missing/malformed
    problem line, unparsable integers, or illegal 0 indices.
    """
    path = os.fspath(path)
    lib = _native_lib()
    if lib is not None:
        nn = ctypes.c_int64()
        na = ctypes.c_int64()
        up = ctypes.POINTER(ctypes.c_int32)()
        vp = ctypes.POINTER(ctypes.c_int32)()
        rc = lib.tpl_parse_dmx(path.encode(), ctypes.byref(nn), ctypes.byref(na),
                               ctypes.byref(up), ctypes.byref(vp))
        if rc == 0:
            m = na.value
            u = np.ctypeslib.as_array(up, shape=(m,)).copy()
            v = np.ctypeslib.as_array(vp, shape=(m,)).copy()
            lib.tpl_free(up)
            lib.tpl_free(vp)
            return nn.value, m, u, v
        if rc > 0:
            # Positive codes are validation failures identical to the Python
            # path's; fall through only on rc < 0 (io/alloc trouble).
            raise DataLoaderError(_NATIVE_ERRORS.get(rc, f"native parser error {rc}"))
    return _parse_dmx_py(path)


_NATIVE_ERRORS = {
    1: "The 'p min' problem line was not found or was malformed.",
    2: "Failed to parse integer in arc line.",
    3: "Invalid node index: DIMACS format requires 1-based positive integers.",
    4: "Node index exceeds declared node count.",
}


def _parse_dmx_py(path) -> Tuple[int, int, np.ndarray, np.ndarray]:
    num_nodes = num_arcs = None
    us: list = []
    vs: list = []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "c":
                continue
            if tag == "p":
                if len(parts) >= 4 and parts[1] == "min":
                    try:
                        num_nodes = int(parts[2])
                        num_arcs = int(parts[3])
                    except ValueError as e:
                        raise DataLoaderError(f"failed to parse problem line: {line!r}") from e
                else:
                    raise DataLoaderError(
                        "The 'p min' problem line was not found or was malformed."
                    )
            elif tag == "a":
                try:
                    u = int(parts[1])
                    v = int(parts[2])
                except (ValueError, IndexError) as e:
                    raise DataLoaderError(f"failed to parse arc line: {line!r}") from e
                if u <= 0 or v <= 0:
                    raise DataLoaderError(
                        f"Invalid node index '{min(u, v)}'. DIMACS format requires "
                        "1-based positive integers."
                    )
                us.append(u - 1)
                vs.append(v - 1)
    if num_nodes is None:
        raise DataLoaderError("The 'p min' problem line was not found or was malformed.")
    u_arr = np.asarray(us, dtype=np.int32)
    v_arr = np.asarray(vs, dtype=np.int32)
    if u_arr.size and (u_arr.max() >= num_nodes or v_arr.max() >= num_nodes):
        raise DataLoaderError("arc endpoint exceeds declared node count")
    if u_arr.size != num_arcs:
        # The reference only debug_asserts this (data_loader.rs:145-148); we
        # accept the parsed count but surface disagreement loudly.
        import warnings

        warnings.warn(
            f"declared arc count {num_arcs} != parsed {u_arr.size}; using parsed",
            stacklevel=2,
        )
        num_arcs = int(u_arr.size)
    return int(num_nodes), int(num_arcs), u_arr, v_arr


def parse_qfc(path, expected_arcs: int) -> np.ndarray:
    """Parse a ``.qfc`` file, returning the quadratic costs (diagonal of D)."""
    with open(path, "r") as fh:
        tokens = fh.read().split()
    if not tokens:
        raise DataLoaderError("unexpected end of file while reading .qfc")
    try:
        m = int(tokens[0])
    except ValueError as e:
        raise DataLoaderError(f"failed to parse arc count from {tokens[0]!r}") from e
    if m != expected_arcs:
        raise DataLoaderError(
            f"qfc file specifies {m} arcs, but dmx file has {expected_arcs}."
        )
    rest = tokens[1:]
    if len(rest) == 2 * m:
        quad = rest[m:]
    elif len(rest) == m:
        quad = rest
    else:
        raise DataLoaderError(
            f".qfc has {len(rest)} cost tokens; expected {m} (quadratic only) "
            f"or {2 * m} (fixed + quadratic)."
        )
    try:
        return np.asarray([float(t) for t in quad], dtype=np.float64)
    except ValueError as e:
        raise DataLoaderError(f"failed to parse float in .qfc: {e}") from e


def load_kkt_arrays(dmx_path, qfc_path) -> KKTArrays:
    """Load and validate a (dmx, qfc) pair into :class:`KKTArrays`.

    The KKT matrix is ``A = [[D, Eᵀ], [E, 0]]`` of dimension
    ``num_arcs + num_nodes`` with the arc block first — the layout assembled
    by the reference's ``load_kkt_system`` (``src/utils/data_loader.rs:211-258``).
    """
    num_nodes, num_arcs, arc_u, arc_v = parse_dmx(dmx_path)
    quad = parse_qfc(qfc_path, num_arcs)
    return KKTArrays(
        quad_costs=quad,
        arc_u=arc_u,
        arc_v=arc_v,
        num_nodes=num_nodes,
        num_arcs=num_arcs,
    )
