"""Binary operators: scalar-scalar folds and element math on [P, T] matrices.

Port of ``filodb_tpu/ops/binop.py`` (ref: query/.../exec/binaryOp/
BinaryOperatorFunction.scala, math and comparisons incl. the ``_bool``
variants; exec/ScalarOperationMapper.scala).

Prometheus semantics: a comparison without ``bool`` is a filter — failing
elements disappear (NaN in the [P, T] matrix, dropped by the presenter);
with ``bool`` it yields 1.0 / 0.0. ``%`` is fmod (the sign of the
dividend), ``^`` is pow.
"""

from __future__ import annotations

import math
import operator

import torch

MATH_OPS = {"+", "-", "*", "/", "%", "^"}
COMPARISON_OPS = {"==", "!=", "<", "<=", ">", ">="}

_MATH = {"+": operator.add, "-": operator.sub, "*": operator.mul,
         "/": operator.truediv, "^": operator.pow}
_COMPARE = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
            "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def _math(op, a, b):
    if op == "%":
        if isinstance(a, float) and isinstance(b, float):
            return math.fmod(a, b)
        if isinstance(a, float):
            # a 0-dim tensor promotes like the Python scalar it replaces
            a = torch.tensor(a, dtype=b.dtype, device=b.device)
        return torch.fmod(a, b)
    if op not in _MATH:
        raise ValueError(op)
    return _MATH[op](a, b)


def _compare(op, a, b):
    if op not in _COMPARE:
        raise ValueError(op)
    return _COMPARE[op](a, b)


def scalar_binop(op: str, a: float, b: float, bool_modifier: bool = False) -> float:
    """Pure-scalar fold (both operands literal)."""
    op = op.removesuffix("_bool")
    if op in MATH_OPS:
        if op == "%":
            return math.fmod(a, b) if b != 0 else math.nan
        if op == "/" and b == 0:
            return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)
        return float(_math(op, a, b))
    ok = _compare(op, a, b)
    if bool_modifier:
        return 1.0 if ok else 0.0
    # scalar comparisons without bool are only legal via filter semantics
    return a if ok else math.nan


def _bool_of(ok, missing):
    """1.0 / 0.0 where ``ok``, NaN where an operand is missing (f64)."""
    one = torch.where(ok, 1.0, 0.0).to(torch.float64)
    return torch.where(missing, float("nan"), one)


def apply_scalar_op(op: str, scalar, values, scalar_is_lhs: bool):
    """values: [P, T] tensor; ``scalar`` a float or a [T] f64 tensor of a
    step-varying scalar. Returns the same shape; NaN propagates (missing
    stays missing)."""
    bool_mod = op.endswith("_bool")
    op = op.removesuffix("_bool")
    a, b = (scalar, values) if scalar_is_lhs else (values, scalar)
    if op in MATH_OPS:
        return _math(op, a, b).to(values.dtype)
    ok = _compare(op, a, b)
    if bool_mod:
        return _bool_of(ok, torch.isnan(values))
    return torch.where(ok, values, float("nan"))


def apply_vector_op(op: str, lhs, rhs):
    """Aligned [P, T] tensors (join alignment done by the exec layer).
    A comparison keeps the LHS value where true (Prometheus filter
    semantics)."""
    bool_mod = op.endswith("_bool")
    op = op.removesuffix("_bool")
    if op in MATH_OPS:
        return _math(op, lhs, rhs)
    ok = _compare(op, lhs, rhs)
    if bool_mod:
        return _bool_of(ok, torch.isnan(lhs) | torch.isnan(rhs))
    return torch.where(ok, lhs, float("nan"))
