"""PromQL frontend: lexer + recursive-descent (Pratt) parser -> AST -> LogicalPlan.

Reference: prometheus/src/main/scala/filodb/prometheus/parse/Parser.scala (Packrat
parser-combinators) + ast/ (Vectors, Expressions, Functions, Aggregates, Operators,
TimeUnits) — incl. the lowering rules in toSeriesPlan: ``__name__`` becomes the
configured metric column, shard-key tags (``_ws_``/``_ns_``) pass through, and
range selectors extend the raw lookback window.

Coverage matches the reference's ~60% of PromQL: literals, vector/range selectors,
offset, all enum'd functions, aggregations with by/without and k/quantile params,
arithmetic/comparison/set binary operators with bool modifier, on/ignoring,
group_left/group_right, unary minus, parentheses — plus, beyond the reference:
subqueries ``expr[1h:5m]`` (lowered to a nested range evaluation executed by
SubqueryWindowExec) and the ``@ <unix-seconds>`` modifier on vector selectors
(lowering pins the selector's start/end at the pinned instant and broadcasts
the result across the query grid; recording rules REJECT ``@`` — see
``reject_at_modifier``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..core.filters import Equals, EqualsRegex, Filter, NotEquals, NotEqualsRegex
from ..query import logical as L

DEFAULT_STALENESS_MS = 5 * 60 * 1000  # ref: query config stale-sample-after 5m

RANGE_FNS = {
    "rate", "increase", "delta", "irate", "idelta", "sum_over_time",
    "count_over_time", "avg_over_time", "min_over_time", "max_over_time",
    "stddev_over_time", "stdvar_over_time", "last_over_time", "changes",
    "resets", "deriv",
}
# range fns with extra scalar args: name -> (scalar positions, vector position)
RANGE_FNS_ARGS = {
    "predict_linear": ((1,), 0),
    "quantile_over_time": ((0,), 1),
    "holt_winters": ((1, 2), 0),
}
INSTANT_FNS = {
    "abs", "absent", "ceil", "exp", "floor", "ln", "log10", "log2", "round",
    "sqrt", "days_in_month", "day_of_month", "day_of_week", "hour", "minute",
    "month", "year",
}
INSTANT_FNS_ARGS = {
    "clamp_max": ((1,), 0),
    "clamp_min": ((1,), 0),
    "round": ((1,), 0),
    "histogram_quantile": ((0,), 1),
    "histogram_max_quantile": ((0,), 1),
    "histogram_bucket": ((0,), 1),
}
MISC_FNS = {"label_replace", "label_join", "timestamp"}
SORT_FNS = {"sort", "sort_desc"}
SCALAR_FNS = {"time", "scalar", "vector"}   # ref: ast/Functions.scala allows vector/time
FILO_FNS = {"_filodb_chunkmeta_all"}        # ref: FiloFunctionId.ChunkMetaAll
AGG_OPS = {
    "sum", "avg", "count", "min", "max", "stddev", "stdvar", "topk", "bottomk",
    "count_values", "quantile",
}

_DUR_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000,
           "w": 604_800_000, "y": 31_536_000_000}

# omitted subquery step (``expr[1h:]``): the Prometheus analog resolves it
# from the global evaluation interval; here one documented constant
DEFAULT_SUBQUERY_STEP_MS = 60_000

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<DURATION>\d+(?:ms|[smhdwy]))
  | (?P<NUMBER>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|0x[0-9a-fA-F]+|[Ii]nf|NaN)
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<IDENT>[a-zA-Z_:][a-zA-Z0-9_:]*)
  | (?P<OP>=~|!~|!=|==|<=|>=|\^|@|[-+*/%(){}\[\],=<>:])
""", re.X)

KEYWORDS = {"by", "without", "on", "ignoring", "group_left", "group_right",
            "offset", "and", "or", "unless", "bool"}


@dataclass
class Token:
    kind: str
    text: str
    pos: int


class ParseError(ValueError):
    pass


def _lex(s: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ParseError(f"unexpected character {s[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind != "WS":
            out.append(Token(kind, m.group(), pos))
        pos = m.end()
    out.append(Token("EOF", "", pos))
    return out


def parse_duration_ms(text: str) -> int:
    m = re.fullmatch(r"(\d+)(ms|[smhdwy])", text)
    if not m:
        raise ParseError(f"bad duration {text!r}")
    return int(m.group(1)) * _DUR_MS[m.group(2)]


# ---- AST --------------------------------------------------------------------

@dataclass
class Expr:
    pass


@dataclass
class NumberLit(Expr):
    value: float


@dataclass
class StringLit(Expr):
    value: str


@dataclass
class VectorSelector(Expr):
    metric: str
    matchers: list[Filter]
    window_ms: int | None = None      # set for range selectors m[5m]
    offset_ms: int = 0
    at_ms: int | None = None          # set by the @ <unix-seconds> modifier


@dataclass
class Subquery(Expr):
    """``expr[range:step]`` — the inner expression re-evaluated on a
    ``step``-aligned grid covering the trailing ``range`` at every outer
    step (an omitted step defaults to DEFAULT_SUBQUERY_STEP_MS, the
    Prometheus default-evaluation-interval analog)."""
    expr: Expr
    range_ms: int
    step_ms: int
    offset_ms: int = 0


@dataclass
class Call(Expr):
    func: str
    args: list[Expr]


@dataclass
class AggregateExpr(Expr):
    op: str
    expr: Expr
    param: Expr | None = None
    by: tuple[str, ...] = ()
    without: tuple[str, ...] = ()


@dataclass
class BinaryExpr(Expr):
    op: str
    lhs: Expr
    rhs: Expr
    bool_modifier: bool = False
    on: tuple[str, ...] = ()
    ignoring: tuple[str, ...] = ()
    group_left: bool = False
    group_right: bool = False
    include: tuple[str, ...] = ()
    has_vector_matching: bool = False


@dataclass
class UnaryExpr(Expr):
    op: str
    expr: Expr


# precedence (higher binds tighter); right-assoc only for ^
_PRECEDENCE = {
    "or": 1, "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<=": 3, "<": 3, ">=": 3, ">": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
    "^": 6,
}
_SET_OPS = {"and", "or", "unless"}
_COMPARISON_OPS = {"==", "!=", "<=", "<", ">=", ">"}


class Parser:
    def __init__(self, text: str):
        self.tokens = _lex(text)
        self.i = 0

    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if self.i < len(self.tokens) - 1:  # stay on EOF once reached
            self.i += 1
        return t

    def expect(self, text: str) -> Token:
        t = self.next()
        if t.text != text:
            raise ParseError(f"expected {text!r}, got {t.text!r} at {t.pos}")
        return t

    # -- entry ---------------------------------------------------------------

    def parse(self) -> Expr:
        e = self.parse_expr(0)
        if self.peek().kind != "EOF":
            t = self.peek()
            raise ParseError(f"unexpected {t.text!r} at {t.pos}")
        return e

    def parse_expr(self, min_prec: int) -> Expr:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            op = t.text if t.text in _PRECEDENCE else None
            if op is None or (t.kind == "IDENT" and op not in _SET_OPS):
                break
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                break
            self.next()
            be = BinaryExpr(op, lhs, NumberLit(0))
            if self.peek().text == "bool":
                self.next()
                be.bool_modifier = True
            if self.peek().text in ("on", "ignoring"):
                which = self.next().text
                labels = self._label_list()
                be.has_vector_matching = True
                if which == "on":
                    be.on = labels
                else:
                    be.ignoring = labels
                if self.peek().text in ("group_left", "group_right"):
                    gl = self.next().text == "group_left"
                    be.group_left, be.group_right = gl, not gl
                    if self.peek().text == "(":
                        be.include = self._label_list()
            next_min = prec + (0 if op == "^" else 1)
            be.rhs = self.parse_expr(next_min)
            lhs = be
        return lhs

    def parse_unary(self) -> Expr:
        t = self.peek()
        if t.text in ("-", "+"):
            self.next()
            inner = self.parse_unary()
            if t.text == "-":
                if isinstance(inner, NumberLit):
                    return NumberLit(-inner.value)
                return UnaryExpr("-", inner)
            return inner
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.text == "[":
                self.next()
                d = self.next()
                if d.kind != "DURATION":
                    raise ParseError(f"expected duration at {d.pos}")
                if self.peek().text.startswith(":"):
                    # subquery ``expr[range:step]``: any instant-vector
                    # expression qualifies (the whole point — rules over
                    # ``max_over_time(rate(m[1m])[1h:5m])`` are idiomatic).
                    # The colon may arrive fused into one IDENT token
                    # (":5m" — identifiers admit leading colons for
                    # recording-rule names) or standalone ("[1h : 5m]").
                    tail = self.next().text[1:]
                    step_ms = DEFAULT_SUBQUERY_STEP_MS
                    if tail:
                        step_ms = parse_duration_ms(tail)
                    elif self.peek().kind == "DURATION":
                        step_ms = parse_duration_ms(self.next().text)
                    self.expect("]")
                    if isinstance(e, VectorSelector) \
                            and e.window_ms is not None:
                        raise ParseError(
                            "subquery requires an instant vector, "
                            "got a range selector")
                    if step_ms <= 0:
                        raise ParseError("subquery step must be positive")
                    e = Subquery(e, parse_duration_ms(d.text), step_ms)
                else:
                    self.expect("]")
                    if not isinstance(e, VectorSelector):
                        raise ParseError(
                            "range selector requires a vector selector")
                    e.window_ms = parse_duration_ms(d.text)
            elif t.text == "offset":
                self.next()
                d = self.next()
                if d.kind != "DURATION":
                    raise ParseError(f"expected duration at {d.pos}")
                if not isinstance(e, (VectorSelector, Subquery)):
                    raise ParseError("offset requires a vector selector "
                                     "or subquery")
                e.offset_ms = parse_duration_ms(d.text)
            elif t.text == "@":
                # @ <unix-seconds>: pin the selector's evaluation instant
                # (ref upstream promql/parser: stepInvariantExpr). Applies
                # to the SELECTOR only — @ on a subquery is out of scope.
                self.next()
                ts = self.next()
                if ts.kind != "NUMBER":
                    raise ParseError(
                        f"@ expects a unix timestamp in seconds at {ts.pos}")
                if not isinstance(e, VectorSelector):
                    raise ParseError("@ modifier requires a vector selector")
                try:
                    at_s = float(ts.text)
                except ValueError:
                    at_s = float("nan")      # 0x... hex: not a timestamp
                if not (at_s == at_s and abs(at_s) != float("inf")):
                    raise ParseError(
                        f"@ expects a finite unix timestamp, got {ts.text!r}"
                        f" at {ts.pos}")
                e.at_ms = int(at_s * 1000)
            else:
                break
        return e

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "EOF":
            raise ParseError("unexpected end of query")
        if t.text == "(":
            e = self.parse_expr(0)
            self.expect(")")
            return e
        if t.kind == "NUMBER":
            txt = t.text
            if txt.lower().startswith("0x"):
                return NumberLit(float(int(txt, 16)))
            if txt.lower() == "inf":
                return NumberLit(float("inf"))
            return NumberLit(float(txt))
        if t.kind == "STRING":
            return StringLit(_unquote(t.text))
        if t.kind == "DURATION":
            raise ParseError(f"unexpected duration at {t.pos}")
        if t.kind == "IDENT":
            name = t.text
            if name in AGG_OPS:
                return self._aggregate(name)
            if self.peek().text == "(" and (
                name in RANGE_FNS or name in RANGE_FNS_ARGS or name in INSTANT_FNS
                or name in INSTANT_FNS_ARGS or name in MISC_FNS or name in SORT_FNS
                or name in SCALAR_FNS or name in FILO_FNS
            ):
                return Call(name, self._call_args())
            if name in KEYWORDS:
                raise ParseError(f"unexpected keyword {name!r} at {t.pos}")
            return self._vector_selector(name)
        if t.text == "{":
            self.i -= 1
            return self._vector_selector("")
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def _call_args(self) -> list[Expr]:
        self.expect("(")
        args: list[Expr] = []
        if self.peek().text != ")":
            args.append(self.parse_expr(0))
            while self.peek().text == ",":
                self.next()
                args.append(self.parse_expr(0))
        self.expect(")")
        return args

    def _aggregate(self, op: str) -> Expr:
        by = without = ()
        if self.peek().text in ("by", "without"):
            which = self.next().text
            labels = self._label_list()
            if which == "by":
                by = labels
            else:
                without = labels
        args = self._call_args()
        if self.peek().text in ("by", "without"):
            which = self.next().text
            labels = self._label_list()
            if which == "by":
                by = labels
            else:
                without = labels
        param = None
        if op in ("topk", "bottomk", "quantile", "count_values"):
            if len(args) != 2:
                raise ParseError(f"{op} expects (param, vector)")
            param, expr = args
        else:
            if len(args) != 1:
                raise ParseError(f"{op} expects one argument")
            expr = args[0]
        return AggregateExpr(op, expr, param, by, without)

    def _label_list(self) -> tuple[str, ...]:
        self.expect("(")
        labels = []
        if self.peek().text != ")":
            labels.append(self.next().text)
            while self.peek().text == ",":
                self.next()
                labels.append(self.next().text)
        self.expect(")")
        return tuple(labels)

    def _vector_selector(self, metric: str) -> VectorSelector:
        matchers: list[Filter] = []
        if self.peek().text == "{":
            self.next()
            while self.peek().text != "}":
                lname = self.next().text
                op = self.next().text
                val = _unquote(self.next().text)
                if op == "=":
                    matchers.append(Equals(lname, val))
                elif op == "!=":
                    matchers.append(NotEquals(lname, val))
                elif op == "=~":
                    validate_matcher_regex(lname, val, negated=False)
                    matchers.append(EqualsRegex(lname, val))
                elif op == "!~":
                    validate_matcher_regex(lname, val, negated=True)
                    matchers.append(NotEqualsRegex(lname, val))
                else:
                    raise ParseError(f"bad matcher op {op!r}")
                if self.peek().text == ",":
                    self.next()
            self.expect("}")
        return VectorSelector(metric, matchers)


def _unquote(s: str) -> str:
    body = s[1:-1]
    return body.encode().decode("unicode_escape")


# regex matchers longer than this are refused at parse time: the index
# compiles and caches matcher patterns, and a multi-KB pattern is a typo or
# a hostile payload, not a selector (the reference bounds query sizes the
# same way — a fiat limit, typed at the edge)
MAX_MATCHER_PATTERN_LEN = 1024


def validate_matcher_regex(label: str, pattern: str,
                           negated: bool = False) -> None:
    """Compile a matcher regex ONCE at parse time (re's compile cache makes
    later index-side compiles free) with a bounded pattern length, raising a
    typed ParseError naming the offending matcher — an invalid or
    catastrophic pattern must be a 422 at the edge, never a 500 from the
    middle of a shard select."""
    op = "!~" if negated else "=~"
    if len(pattern) > MAX_MATCHER_PATTERN_LEN:
        raise ParseError(
            f"regex in matcher {label}{op}... is {len(pattern)} chars "
            f"(max {MAX_MATCHER_PATTERN_LEN})")
    try:
        re.compile(pattern)
    except re.error as e:
        raise ParseError(
            f"invalid regex in matcher {label}{op}{pattern!r}: {e}") from None


def parse_query(text: str) -> Expr:
    return Parser(text).parse()


# ---- AST -> LogicalPlan lowering -------------------------------------------

class QueryParams:
    def __init__(self, start_ms: int, end_ms: int, step_ms: int,
                 metric_column: str = "_metric_",
                 staleness_ms: int = DEFAULT_STALENESS_MS):
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.step_ms = max(step_ms, 1)
        self.metric_column = metric_column
        self.staleness_ms = staleness_ms


def to_logical_plan(expr: Expr, p: QueryParams) -> L.LogicalPlan:
    return _lower(expr, p)


def query_to_logical_plan(text: str, start_ms: int, end_ms: int,
                          step_ms: int = 0, **kw) -> L.LogicalPlan:
    """query_range entry (ref Parser.queryRangeToLogicalPlan); step 0 = instant."""
    return to_logical_plan(parse_query(text), QueryParams(start_ms, end_ms, step_ms, **kw))


def _raw(vs: VectorSelector, p: QueryParams, lookback_ms: int) -> L.RawSeries:
    filters = list(vs.matchers)
    metric = vs.metric
    name_col = ()
    if metric and "::" in metric:
        # value-column suffix: ``metric::col`` selects a data column of a
        # multi-column schema (ref: ast/Vectors.scala metric name "::" split)
        metric, _, suffix = metric.partition("::")
        if not suffix or not metric:
            raise ParseError(f"malformed ::column selector in {vs.metric!r}")
        name_col = (suffix,)
    if metric:
        filters.append(Equals(p.metric_column, metric))
    # __name__ matcher is an alias for the metric column (ref ast/Vectors.scala)
    filters = [Equals(p.metric_column, f.value) if isinstance(f, Equals) and f.label == "__name__"
               else f for f in filters]
    # __col__ selects the value column (ref ast/Vectors.scala __col__; here a
    # downsample family's aggregate dataset, e.g. {__col__="dAvg"})
    col_matchers = [f for f in filters if getattr(f, "label", "") == "__col__"]
    if any(not isinstance(f, Equals) for f in col_matchers):
        raise ParseError("__col__ only supports equality matching")
    columns = tuple(dict.fromkeys(
        name_col + tuple(f.value for f in col_matchers)))
    if len(columns) > 1:
        raise ParseError(f"conflicting __col__ selectors: {columns}")
    filters = [f for f in filters if getattr(f, "label", "") != "__col__"]
    start = p.start_ms - vs.offset_ms - lookback_ms
    end = p.end_ms - vs.offset_ms
    return L.RawSeries(L.IntervalSelector(start, end), tuple(filters), columns)


def _pin_params(p: QueryParams, at_ms: int) -> QueryParams:
    """Query params with start/end PINNED at the @ timestamp: the selector
    evaluates once, at ``at_ms``, regardless of the query grid."""
    return QueryParams(at_ms, at_ms, 1, p.metric_column, p.staleness_ms)


def _lower_vector(vs: VectorSelector, p: QueryParams) -> L.PeriodicSeriesPlan:
    if vs.window_ms is not None:
        raise ParseError("range selector used where instant vector expected")
    if vs.at_ms is not None:
        pinned = _pin_params(p, vs.at_ms)
        raw = _raw(vs, pinned, p.staleness_ms)
        inner = L.PeriodicSeries(raw, pinned.start_ms - vs.offset_ms, 1,
                                 pinned.end_ms - vs.offset_ms)
        return L.ApplyAtTimestamp(inner, p.start_ms, p.step_ms, p.end_ms)
    raw = _raw(vs, p, p.staleness_ms)
    return L.PeriodicSeries(raw, p.start_ms - vs.offset_ms, p.step_ms, p.end_ms - vs.offset_ms)


def _scalar_value(e: Expr) -> float:
    if isinstance(e, NumberLit):
        return e.value
    if isinstance(e, StringLit):
        raise ParseError("expected scalar, got string")
    raise ParseError("expected a scalar literal argument")


def _lower(e: Expr, p: QueryParams) -> L.LogicalPlan:
    if isinstance(e, NumberLit):
        return L.ScalarPlan(e.value, p.start_ms, p.step_ms, p.end_ms)
    if isinstance(e, VectorSelector):
        return _lower_vector(e, p)
    if isinstance(e, UnaryExpr):
        inner = _lower(e.expr, p)
        return L.ScalarVectorBinaryOperation("*", -1.0, inner, scalar_is_lhs=True)
    if isinstance(e, AggregateExpr):
        inner = _lower(e.expr, p)
        params = ()
        if e.param is not None:
            if isinstance(e.param, StringLit):
                params = (e.param.value,)
            else:
                params = (_scalar_value(e.param),)
        return L.Aggregate(e.op, inner, params, e.by, e.without)
    if isinstance(e, Call):
        return _lower_call(e, p)
    if isinstance(e, BinaryExpr):
        return _lower_binary(e, p)
    if isinstance(e, Subquery):
        raise ParseError(
            "subquery must be the argument of a range function, e.g. "
            "max_over_time(expr[1h:5m])")
    raise ParseError(f"cannot lower {e!r}")


_SCALAR_PLANS = (L.ScalarPlan, L.TimeScalarPlan, L.ScalarOfVector)


def _lower_call(e: Call, p: QueryParams) -> L.LogicalPlan:
    name = e.func
    if name == "_filodb_chunkmeta_all":
        # chunk-metadata debug plan (ref: FiloFunctionId.ChunkMetaAll ->
        # RawChunkMeta, Functions.scala:48; no lookback — metadata only)
        if len(e.args) != 1 or not isinstance(e.args[0], VectorSelector):
            raise ParseError(f"{name} expects one vector selector")
        vs = e.args[0]
        raw = _raw(vs, p, 0)
        return L.RawChunkMeta(raw.range_selector, raw.filters,
                              raw.columns[0] if raw.columns else "")
    if name == "time":
        if e.args:
            raise ParseError("time() takes no arguments")
        return L.TimeScalarPlan(p.start_ms, p.step_ms, p.end_ms)
    if name == "scalar":
        if len(e.args) != 1:
            raise ParseError("scalar() expects one instant vector")
        inner = _lower(e.args[0], p)
        if isinstance(inner, _SCALAR_PLANS):
            raise ParseError("scalar() expects an instant vector")
        return L.ScalarOfVector(inner)
    if name == "vector":
        if len(e.args) != 1:
            raise ParseError("vector() expects one scalar")
        inner = _lower(e.args[0], p)
        if not isinstance(inner, _SCALAR_PLANS):
            raise ParseError("vector() expects a scalar expression")
        return L.VectorOfScalar(inner)
    if name in RANGE_FNS or name in RANGE_FNS_ARGS:
        if name in RANGE_FNS_ARGS:
            scal_pos, vec_pos = RANGE_FNS_ARGS[name]
            fn_args = tuple(_scalar_value(e.args[i]) for i in scal_pos)
            vec = e.args[vec_pos]
        else:
            if len(e.args) != 1:
                raise ParseError(f"{name} expects one range vector")
            fn_args = ()
            vec = e.args[0]
        if isinstance(vec, Subquery):
            return _lower_subquery(name, fn_args, vec, p)
        if not isinstance(vec, VectorSelector) or vec.window_ms is None:
            raise ParseError(f"{name} expects a range selector like m[5m]")
        if vec.at_ms is not None:
            pinned = _pin_params(p, vec.at_ms)
            raw = _raw(vec, pinned, vec.window_ms)
            inner = L.PeriodicSeriesWithWindowing(
                raw, pinned.start_ms - vec.offset_ms, 1,
                pinned.end_ms - vec.offset_ms, vec.window_ms, name, fn_args)
            return L.ApplyAtTimestamp(inner, p.start_ms, p.step_ms, p.end_ms)
        raw = _raw(vec, p, vec.window_ms)
        return L.PeriodicSeriesWithWindowing(
            raw, p.start_ms - vec.offset_ms, p.step_ms, p.end_ms - vec.offset_ms,
            vec.window_ms, name, fn_args)
    if name in INSTANT_FNS or name in INSTANT_FNS_ARGS:
        if name in INSTANT_FNS_ARGS and len(e.args) > 1:
            scal_pos, vec_pos = INSTANT_FNS_ARGS[name]
            fn_args = tuple(_scalar_value(e.args[i]) for i in scal_pos)
            vec = e.args[vec_pos]
        else:
            fn_args = ()
            vec = e.args[0]
        return L.ApplyInstantFunction(_lower(vec, p), name, fn_args)
    if name in MISC_FNS:
        vec = _lower(e.args[0], p)
        str_args = tuple(a.value for a in e.args[1:] if isinstance(a, StringLit))
        return L.ApplyMiscellaneousFunction(vec, name, str_args)
    if name in SORT_FNS:
        return L.ApplySortFunction(_lower(e.args[0], p), name)
    raise ParseError(f"unknown function {name}")


def _lower_subquery(fn: str, fn_args: tuple, sq: Subquery,
                    p: QueryParams) -> L.LogicalPlan:
    """``fn(inner[range:sub])`` -> SubqueryWithWindowing: the inner instant
    expression lowers onto the absolute sub-step grid covering
    ``(start - range, end]`` (Prometheus aligns subquery evaluation points
    to multiples of the sub-step, not to the outer grid), and the outer
    range function slides over that synthetic stream."""
    sub = max(int(sq.step_ms), 1)
    rng = int(sq.range_ms)
    if rng <= 0:
        raise ParseError("subquery range must be positive")
    start = p.start_ms - sq.offset_ms
    end = p.end_ms - sq.offset_ms
    # first grid point STRICTLY after start - range (PromQL windows are
    # left-open], last at or before end
    inner_start = ((start - rng) // sub + 1) * sub
    inner_end = (end // sub) * sub
    inner_p = QueryParams(inner_start, inner_end, sub, p.metric_column,
                          p.staleness_ms)
    inner = _lower(sq.expr, inner_p)
    if isinstance(inner, _SCALAR_PLANS):
        inner = L.VectorOfScalar(inner)
    return L.SubqueryWithWindowing(inner, start, p.step_ms, end, rng, fn,
                                   fn_args, sub)


def reject_at_modifier(text: str) -> None:
    """Typed guard for recording/alerting rules: an ``@``-pinned selector
    makes the rule's output a constant of wall history instead of a pure
    function of the evaluation timestamp — re-evaluation after failover
    would no longer be idempotent, so rules refuse it at load time."""
    def walk(e: Expr) -> None:
        if isinstance(e, VectorSelector) and e.at_ms is not None:
            raise ParseError(
                "@ modifier is not allowed in rule expressions: a rule must "
                "be a pure function of its evaluation timestamp so "
                "re-evaluation after a crash or failover writes the same "
                "derived samples (exactly-once pub-ids)")
        for v in vars(e).values():
            if isinstance(v, Expr):
                walk(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, Expr):
                        walk(x)
    walk(parse_query(text))


def _lower_binary(e: BinaryExpr, p: QueryParams) -> L.LogicalPlan:
    lhs = _lower(e.lhs, p)
    rhs = _lower(e.rhs, p)
    lhs_scalar = isinstance(lhs, _SCALAR_PLANS)
    rhs_scalar = isinstance(rhs, _SCALAR_PLANS)
    op = e.op + ("_bool" if e.bool_modifier else "")
    if (lhs_scalar and rhs_scalar
            and isinstance(lhs, L.ScalarPlan) and isinstance(rhs, L.ScalarPlan)):
        if e.op in _COMPARISON_OPS and not e.bool_modifier:
            raise ParseError("comparisons between scalars must use BOOL modifier")
        from ..ops.binop import scalar_binop
        return L.ScalarPlan(scalar_binop(e.op, lhs.value, rhs.value, e.bool_modifier),
                            p.start_ms, p.step_ms, p.end_ms)
    if lhs_scalar or rhs_scalar:
        if e.op in _SET_OPS:
            raise ParseError(f"set operator {e.op} not allowed with scalar")
        if lhs_scalar and rhs_scalar:
            if e.op in _COMPARISON_OPS and not e.bool_modifier:
                raise ParseError(
                    "comparisons between scalars must use BOOL modifier")
            # step-varying scalar on at least one side: evaluate as a
            # 1-series vector op; the result is scalar-typed again
            svbo = L.ScalarVectorBinaryOperation(
                op, lhs.value if isinstance(lhs, L.ScalarPlan) else lhs,
                L.VectorOfScalar(rhs), scalar_is_lhs=True)
            return L.ScalarOfVector(svbo)
        sp = lhs if lhs_scalar else rhs
        vec = rhs if lhs_scalar else lhs
        scalar = sp.value if isinstance(sp, L.ScalarPlan) else sp
        return L.ScalarVectorBinaryOperation(op, scalar, vec,
                                             scalar_is_lhs=lhs_scalar)
    card = "OneToOne" if not (e.group_left or e.group_right) else (
        "ManyToOne" if e.group_left else "OneToMany")
    if e.op in _SET_OPS:
        card = "ManyToMany"
    return L.BinaryJoin(lhs, op, card, rhs, e.on, e.ignoring, e.include)
