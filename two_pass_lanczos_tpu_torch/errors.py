"""Typed failure taxonomy for the Lanczos framework.

Mirrors the capability of the reference error module (see reference
``src/error.rs:13-66``): a single exception family with a structured *kind*,
covering breakdown, dimension mismatches, invalid inputs, parameter
mismatches, eigendecomposition failures, and user-solver failures.

Design note (TPU-native): numerical *breakdown* is normally a graceful early
termination (``steps_taken`` truncates downstream work, exactly like the
reference); :class:`BreakdownError` is raised only when the solver is
explicitly asked to treat breakdown as fatal via
``lanczos(..., strict_breakdown=True)`` / ``lanczos_two_pass(...,
strict_breakdown=True)``. Inside ``jax.jit``-traced code no Python
exception can be raised on traced values; the jitted kernels therefore encode
failure states in outputs (``steps_taken == 0`` for a zero input vector) and
the host-level API converts them to these exceptions.
"""

from __future__ import annotations

__all__ = [
    "LanczosError",
    "BreakdownError",
    "DimensionMismatchError",
    "InputError",
    "ParameterMismatchError",
    "EvdError",
    "SolverError",
]


class LanczosError(Exception):
    """Base class for all errors raised by the framework."""


class BreakdownError(LanczosError):
    """Numerical breakdown: the Krylov subspace became invariant at step ``k``.

    Reference parity: ``LanczosErrorKind::Breakdown { k }``
    (reference ``src/error.rs:26``).
    """

    def __init__(self, k: int):
        self.k = int(k)
        super().__init__(
            f"Numerical breakdown occurred at iteration {self.k}: beta is "
            "numerically zero (the Krylov subspace is invariant)."
        )


class DimensionMismatchError(LanczosError):
    """Operator/vector dimensions are incompatible.

    Reference parity: ``LanczosErrorKind::DimensionMismatch``
    (reference ``src/error.rs:33``).
    """

    def __init__(self, expected: int, actual: int, what: str = "vector"):
        self.expected = int(expected)
        self.actual = int(actual)
        super().__init__(
            f"Dimension mismatch for {what}: expected {self.expected}, "
            f"got {self.actual}."
        )


class InputError(LanczosError):
    """Invalid input (e.g. a zero starting vector).

    Reference parity: ``LanczosErrorKind::InputError`` (``src/error.rs:39``).
    """


class ParameterMismatchError(LanczosError):
    """A user-supplied object has the wrong size (e.g. ``f(T_k) e_1`` result).

    Reference parity: ``LanczosErrorKind::ParameterMismatch``
    (``src/error.rs:44``).
    """

    def __init__(self, param_name: str, expected: int, actual: int):
        self.param_name = param_name
        self.expected = int(expected)
        self.actual = int(actual)
        super().__init__(
            f"Parameter '{param_name}' has mismatched size: expected "
            f"{self.expected}, got {self.actual}."
        )


class EvdError(LanczosError):
    """Eigendecomposition of the projected tridiagonal system failed.

    Reference parity: ``LanczosErrorKind::EvdError`` (``src/error.rs:52``).
    """


class SolverError(LanczosError):
    """The user-provided ``f(T_k) e_1`` solver raised an error.

    Reference parity: ``LanczosErrorKind::SolverError`` (``src/error.rs:56``).
    """
