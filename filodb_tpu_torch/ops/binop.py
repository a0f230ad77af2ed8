"""Scalar-scalar binary operators, folded at parse time.

Reference: query/.../exec/binaryOp/BinaryOperatorFunction.scala. Only the
pure-scalar fold the PromQL parser needs (``1 + 2``) lives here; the vector
operators come with a later slice of the port.
"""

from __future__ import annotations

import math
import operator

MATH_OPS = {"+", "-", "*", "/", "%", "^"}
COMPARISON_OPS = {"==", "!=", "<", "<=", ">", ">="}

_MATH = {"+": operator.add, "-": operator.sub, "*": operator.mul,
         "/": operator.truediv, "^": operator.pow}
_COMPARE = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
            "<=": operator.le, ">": operator.gt, ">=": operator.ge}


def scalar_binop(op: str, a: float, b: float, bool_modifier: bool = False) -> float:
    """Pure-scalar fold (both operands literal)."""
    op = op.removesuffix("_bool")
    if op in MATH_OPS:
        if op == "%":
            return math.fmod(a, b) if b != 0 else math.nan
        if op == "/" and b == 0:
            return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)
        return float(_MATH[op](a, b))
    ok = _COMPARE[op](a, b)
    if bool_modifier:
        return 1.0 if ok else 0.0
    # scalar comparisons without bool are only legal via filter semantics
    return a if ok else math.nan
