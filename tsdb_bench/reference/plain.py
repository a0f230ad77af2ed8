"""Plain answers of the benchmark's query families, and the numbers that
judge an answer against them.

Written from the published semantics (Prometheus' extrapolatedRate, irate,
the ``*_over_time`` windows, PromQL's quantile, histogram_quantile's
bucketQuantile) over FiloDB's window convention: step ``t`` covers the
samples at ``[t - window, t]``, both ends included. The inputs come from
``tsdb_bench/data``; nothing of the program is imported or read.

:func:`evaluate` regenerates a configuration's inputs from the seed block
by block and folds every (query, range) pair it is asked for. In float64
it is the truth an answer is judged by (:meth:`Family.judge`); computed in
a lower precision it stands in the program's place as the control
(:meth:`Family.answer`).
"""

from __future__ import annotations

import importlib
import re
from dataclasses import dataclass

import numpy as np
import torch

INF = float("inf")


@dataclass
class Answer:
    """One answer in the form the judges read: ``values`` f64 ``[P, T]``
    (``[P, T, B]`` for histograms), NaN where a series has no point;
    ``rows`` the series' rows in the configuration (None for aggregates)."""
    out_ts: np.ndarray
    values: np.ndarray
    rows: list | None = None


def steps_of(rng: tuple[int, int, int]) -> np.ndarray:
    start, end, step = rng
    return np.arange(start, end + 1, step, dtype=np.int64)


def window_cells(cfg: dict, steps: np.ndarray, window_ms: int):
    """Per step, the first and last sample index inside ``[t - window, t]``
    (every series of a configuration shares its sample grid)."""
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    lo = np.maximum(-(-(steps - window_ms - base) // iv), 0)
    hi = np.minimum((steps - base) // iv, cfg["samples_per_series"] - 1)
    return lo, hi


def range_fn(x: torch.Tensor, fn: str, cfg: dict, steps: np.ndarray,
             window_ms: int, dtype) -> torch.Tensor:
    """``fn`` over every row of ``x`` ([R, C] or [R, C, B], f32 samples)
    at ``steps``: [R, T] (or [R, T, B]) in ``dtype``, NaN where undefined.
    ``last`` is the instant selector: the newest sample of the lookback
    ``[t - window, t]``."""
    x = x.to(dtype)
    dev = x.device
    lo, hi = window_cells(cfg, steps, window_ms)
    cnt = hi - lo + 1
    T = len(steps)
    lo_t = torch.from_numpy(np.clip(lo, 0, None)).to(dev)
    hi_t = torch.from_numpy(np.clip(hi, 0, None)).to(dev)
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)

    def per_step(v):                  # [T] host values -> broadcastable
        shape = (1, T) + (1,) * (x.dim() - 2)
        return torch.tensor(v, dtype=dtype, device=dev).reshape(shape)

    def ok(mask):
        shape = (1, T) + (1,) * (x.dim() - 2)
        return torch.from_numpy(mask).to(dev).reshape(shape)

    if fn == "last":
        return torch.where(ok(cnt >= 1), x[:, hi_t], nan)
    if fn == "max_over_time":
        cols = [x[:, lo[k]:hi[k] + 1].amax(1) if cnt[k] >= 1
                else torch.full_like(x[:, 0], float("nan")) for k in range(T)]
        return torch.stack(cols, 1)
    if fn == "irate":
        v2, v1 = x[:, hi_t], x[:, (hi_t - 1).clamp(min=0)]
        dt = per_step(np.full(T, cfg["interval_ms"] / 1000.0))
        # a reset between the last two samples: the counter restarted
        return torch.where(ok(cnt >= 2), torch.where(v2 >= v1, v2 - v1, v2)
                           / dt, nan)
    if fn != "rate":
        raise ValueError(f"no plain range function {fn!r}")
    # counter resets: each drop adds the value before it back
    prev = torch.cat([x[:, :1], x[:, :-1]], 1)
    drops = torch.cumsum(torch.where(x < prev, prev, torch.zeros_like(x)), 1)
    first_v = x[:, lo_t]
    last_v = x[:, hi_t] + (drops[:, hi_t] - drops[:, lo_t])
    base, iv = cfg["base_ts_ms"], cfg["interval_ms"]
    first_t, last_t = base + lo * iv, base + hi * iv
    with np.errstate(divide="ignore", invalid="ignore"):
        sampled = (last_t - first_t) / 1000.0
        avg = sampled / (cnt - 1)
    dur_start = per_step((first_t - (steps - window_ms)) / 1000.0)
    dur_end = per_step((steps - last_t) / 1000.0)
    sampled_t, avg_t = per_step(sampled), per_step(avg)
    delta = last_v - first_v
    dur_zero = sampled_t * (first_v / delta)
    dur_start = torch.where((delta > 0) & (first_v >= 0)
                            & (dur_zero < dur_start), dur_zero, dur_start)
    thresh = avg_t * 1.1
    extrap = (sampled_t + torch.where(dur_start < thresh, dur_start, avg_t / 2)
              + torch.where(dur_end < thresh, dur_end, avg_t / 2))
    rate = delta * (extrap / sampled_t) / per_step(np.full(T, window_ms
                                                           / 1000.0))
    return torch.where(ok(cnt >= 2), rate, nan)


# ---- comparisons -----------------------------------------------------------

def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / |want| over the cells; a cell present on one
    side only, or a shape that differs, reads inf."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return INF
    gn, wn = np.isnan(got), np.isnan(want)
    if (gn != wn).any():
        return INF
    g, w = got[~wn], want[~wn]
    if g.size == 0:
        return 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        err = np.where(g == w, 0.0, np.abs(g - w) / np.abs(w))
    return float(np.nan_to_num(err, nan=INF).max())


def _single(ans: Answer, steps: np.ndarray) -> np.ndarray | None:
    """An aggregate's one series, or None when the answer has another
    shape or other steps."""
    if ans.values.shape[0] != 1 or not np.array_equal(ans.out_ts, steps):
        return None
    return ans.values[0]


# ---- families --------------------------------------------------------------

class Family:
    """One (query, range) pair's plain answer, folded block by block."""

    def __init__(self, spec: dict, steps: np.ndarray):
        self.spec, self.steps = spec, steps

    def needs(self) -> list[tuple]:
        """The (column, fn, window) row matrices this family folds."""
        raise NotImplementedError

    def fold(self, r0: int, mats: dict) -> None:
        raise NotImplementedError

    def answer(self) -> Answer:
        raise NotImplementedError

    def judge(self, ans: Answer) -> dict[str, float]:
        raise NotImplementedError


class _Agg:
    """sum / avg / max across series of one row matrix."""

    def __init__(self, spec: dict, cfg: dict, labels):
        self.agg = spec["agg"]
        self.key = (spec.get("column", "value"), spec["fn"], spec["window_ms"])
        self.mask = None
        m = spec.get("match")
        if m is not None:
            rx = re.compile(m["regex"])
            self.mask = np.array([rx.fullmatch(v) is not None
                                  for v in labels()], bool)
        self.acc = self.cnt = self._value = None

    def fold(self, r0: int, mats: dict) -> None:
        x = mats[self.key]
        if self.mask is not None:
            sel = torch.from_numpy(self.mask[r0:r0 + x.shape[0]]).to(x.device)
            x = x[sel]
        present = ~torch.isnan(x)
        if self.agg == "max":
            part = torch.where(present, x, -INF).amax(0)
        else:
            part = torch.where(present, x, 0).sum(0)
        cnt = present.sum(0)
        if self.acc is None:
            self.acc, self.cnt = part, cnt
        elif self.agg == "max":
            self.acc = torch.maximum(self.acc, part)
            self.cnt = self.cnt + cnt
        else:
            self.acc = self.acc + part
            self.cnt = self.cnt + cnt

    def value(self) -> np.ndarray:
        if self._value is None:
            self._value = self._present()
        return self._value

    def _present(self) -> np.ndarray:
        acc = self.acc
        if self.agg == "avg":
            acc = acc / self.cnt.to(acc.dtype)
        out = acc.double().cpu().numpy()
        return np.where(self.cnt.cpu().numpy() > 0, out, np.nan)


class AggFamily(Family):
    def __init__(self, spec, steps, cfg, labels):
        super().__init__(spec, steps)
        self.a = _Agg(spec, cfg, labels)

    def needs(self):
        return [self.a.key]

    def fold(self, r0, mats):
        self.a.fold(r0, mats)

    def answer(self):
        return Answer(self.steps, self.a.value()[None])

    def judge(self, ans):
        got = _single(ans, self.steps)
        return {"rel_err": INF if got is None
                else rel_err(got, self.a.value())}


class RatioFamily(Family):
    def __init__(self, spec, steps, cfg, labels):
        super().__init__(spec, steps)
        self.num = _Agg(spec["num"], cfg, labels)
        self.den = _Agg(spec["den"], cfg, labels)
        self._low = None

    def needs(self):
        return [self.num.key, self.den.key]

    def fold(self, r0, mats):
        self.num.fold(r0, mats)
        self.den.fold(r0, mats)

    def _value(self):
        if self.num.acc.dtype == torch.float64:
            return self.num.value() / self.den.value()
        # a lower precision divides in its own dtype
        if self._low is None:
            self._low = (self.num.acc / self.den.acc).double().cpu().numpy()
        return self._low

    def answer(self):
        return Answer(self.steps, self._value()[None])

    def judge(self, ans):
        got = _single(ans, self.steps)
        return {"rel_err": INF if got is None else rel_err(got, self._value())}


class _Matrix(Family):
    """Families that need every series' value at every step. Pairs that
    read the same row matrix of the same range share one copy."""

    def __init__(self, spec, steps, cfg, labels, shared):
        super().__init__(spec, steps)
        self.key = (spec.get("column", "value"), spec["fn"], spec["window_ms"])
        self.S = cfg["series"]
        self.shared = shared.setdefault((self.key, steps.tobytes()), {})
        self._cache = {}

    @property
    def m(self):
        return self.shared["m"]

    def needs(self):
        return [self.key]

    def fold(self, r0, mats):
        done = self.shared.setdefault("rows", set())
        if r0 in done:
            return
        done.add(r0)
        x = mats[self.key]
        if "m" not in self.shared:
            self.shared["m"] = torch.empty((self.S, x.shape[1]),
                                           dtype=x.dtype, device=x.device)
        self.shared["m"][r0:r0 + x.shape[0]] = x

    def cached(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]


class TopkFamily(_Matrix):
    """topk(k, fn(m[w])): the answer's series at each step are judged by
    how far their plain value lies below the plain k-th largest
    (``rank_gap``, a share of it), and their values by ``rel_err``."""

    def _top(self):
        k = self.spec["k"]

        def top():
            # among equal values the lower row first: a stable sort
            order = torch.sort(self.m, dim=0, descending=True, stable=True)
            return order.indices[:k], order.values[:k]
        return self.cached("top", top)

    def answer(self):
        idx, _ = self._top()
        rows = sorted(set(idx.flatten().tolist()))
        pos = {r: i for i, r in enumerate(rows)}
        vals = np.full((len(rows), len(self.steps)), np.nan)
        idx_h = idx.cpu().numpy()
        m = self.m[torch.tensor(rows, device=self.m.device)].double()
        m = m.cpu().numpy()
        for t in range(idx_h.shape[1]):
            for r in idx_h[:, t]:
                vals[pos[int(r)], t] = m[pos[int(r)], t]
        return Answer(self.steps, vals, rows)

    def judge(self, ans):
        k = self.spec["k"]
        if ans.rows is None or not np.array_equal(ans.out_ts, self.steps) \
                or not all(0 <= r < self.S for r in ans.rows):
            return {"rank_gap": INF, "rel_err": INF}
        kth = self.cached("kth", lambda: self._top()[1][k - 1].double()
                          .cpu().numpy())
        rows = torch.tensor(ans.rows, dtype=torch.int64, device=self.m.device)
        truth = self.m[rows].double().cpu().numpy()
        got = ans.values
        present = ~np.isnan(got)
        if (present.sum(0) != min(k, self.S)).any() or np.isnan(
                truth[present]).any():
            return {"rank_gap": INF, "rel_err": INF}
        gap = np.where(present, (kth[None] - truth) / np.abs(kth[None]), 0.0)
        return {"rank_gap": float(max(gap.max(), 0.0)),
                "rel_err": rel_err(got[present], truth[present])}


class QuantileFamily(_Matrix):
    """quantile(q, fn(m[w])) across series, PromQL's rank q * (n - 1) with
    linear interpolation between the order statistics."""

    def _value(self):
        def value():
            q = self.spec["q"]
            v = torch.sort(self.m, dim=0).values          # NaN sort last
            n = (~torch.isnan(self.m)).sum(0)
            rank = q * (n - 1).clamp(min=0).to(torch.float64)
            lo = rank.floor().long()
            hi = torch.minimum(lo + 1, (n - 1).clamp(min=0))
            frac = (rank - lo).to(v.dtype)
            a = v.gather(0, lo[None])[0]
            b = v.gather(0, hi[None])[0]
            out = (a + (b - a) * frac).double().cpu().numpy()
            return np.where(n.cpu().numpy() > 0, out, np.nan)
        return self.cached("value", value)

    def answer(self):
        return Answer(self.steps, self._value()[None])

    def judge(self, ans):
        got = _single(ans, self.steps)
        return {"rel_err": INF if got is None else rel_err(got, self._value())}


class CountGtFamily(_Matrix):
    """count(fn(m[w]) > threshold). ``slack`` is the least relative shift
    of the threshold, up or down, at which the plain values give the
    answer's count: 0 when they give it at the threshold itself."""

    def _desc(self):
        return self.cached("desc", lambda: torch.sort(
            torch.nan_to_num(self.m, nan=-INF), dim=0, descending=True).values)

    def _counts(self):
        thr = self.spec["threshold"]
        return self.cached("counts", lambda: (self.m > thr).sum(0).double()
                           .cpu().numpy())

    def answer(self):
        return Answer(self.steps, self._counts()[None])

    def judge(self, ans):
        got = _single(ans, self.steps)
        if got is None or np.isnan(got).any():
            return {"slack": INF}
        thr = self.spec["threshold"]
        n_at = self._counts().astype(np.int64)
        c = got.astype(np.int64)
        if (c != got).any() or (c < 0).any() or (c > self.S).any():
            return {"slack": INF}
        if (c == n_at).all():
            return {"slack": 0.0}
        # over the count: the c-th largest must clear a lower threshold;
        # under it: the (c+1)-th largest must miss a higher one
        idx = np.where(c > n_at, c - 1, c).clip(0, self.S - 1)
        desc = self._desc()
        cols = torch.arange(len(c), device=desc.device)
        v = desc[torch.from_numpy(idx).to(desc.device), cols].double()
        v = v.cpu().numpy()
        slack = np.where(c > n_at, 1.0 - v / thr,
                         np.where(c < n_at, v / thr - 1.0, 0.0))
        return {"slack": float(max(slack.max(), 0.0))}


class HistQuantileFamily(Family):
    """histogram_quantile(q, sum(fn(h[w]))): Prometheus' bucketQuantile
    over the bucket-wise sum of every series."""

    def __init__(self, spec, steps, cfg, labels, les):
        super().__init__(spec, steps)
        self.a = _Agg(dict(spec, agg="sum", column="value"), cfg, labels)
        self.les = les
        self._q = None

    def needs(self):
        return [self.a.key]

    def fold(self, r0, mats):
        self.a.fold(r0, mats)

    def _value(self):
        if self._q is None:
            self._q = self._quantiles()
        return self._q

    def _quantiles(self):
        counts = self.a.acc                      # [T, B] in its dtype
        q, les = self.spec["q"], self.les
        out = np.full(counts.shape[0], np.nan)
        for t in range(counts.shape[0]):
            c = counts[t]
            total = c[-1]
            if not bool(total > 0):
                continue
            rank = total * q
            b = int((c < rank).sum())
            b = min(b, len(les) - 1)
            if b == len(les) - 1:
                out[t] = les[-2]
                continue
            lo_le = 0.0 if b == 0 else les[b - 1]
            lo_c = torch.zeros_like(total) if b == 0 else c[b - 1]
            frac = (rank - lo_c) / (c[b] - lo_c)
            # the interpolation in the counts' own dtype
            val = (torch.tensor(lo_le, dtype=c.dtype, device=c.device)
                   + torch.tensor(les[b] - lo_le, dtype=c.dtype,
                                  device=c.device) * frac)
            out[t] = float(val)
        return out

    def answer(self):
        return Answer(self.steps, self._value()[None])

    def judge(self, ans):
        got = _single(ans, self.steps)
        return {"rel_err": INF if got is None else rel_err(got, self._value())}


FAMILIES = {"agg": AggFamily, "ratio": RatioFamily, "topk": TopkFamily,
            "quantile": QuantileFamily, "count_gt": CountGtFamily,
            "hist_quantile": HistQuantileFamily}


def ranges_of(cfg: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """The mix's (start, end, step) ranges, in ms."""
    r = traffic["ranges"]
    base = cfg["base_ts_ms"]
    return [(base + r["start_ms"] + k * r["start_shift_ms"],
             base + r["end_ms"] + k * r["end_shift_ms"], traffic["step_ms"])
            for k in range(r["count"])]


def data_module(cfg: dict):
    return importlib.import_module(f"tsdb_bench.data.{cfg['data']}")


def evaluate(cfg: dict, traffic: dict, seed: int, device, dtype,
             pairs=None) -> dict:
    """{(query name, range index): Family} for ``pairs`` (every pair of
    the mix by default), folded over the inputs of ``seed`` on ``device``
    in ``dtype`` (float64: the truth; a lower precision: the control)."""
    data = data_module(cfg)
    ranges = ranges_of(cfg, traffic)
    queries = {q["name"]: q for q in traffic["queries"]}
    if pairs is None:
        pairs = [(q, i) for q in queries for i in range(len(ranges))]
    label_cache: list = []

    def labels():
        if not label_cache:
            label_cache.append(data.labels(cfg))
        return label_cache[0]

    extra = {HistQuantileFamily: (data.les(cfg) if hasattr(data, "les")
                                  else None,)}
    shared: dict = {}
    fams = {}
    for name, ri in pairs:
        spec = queries[name]["reference"]
        cls = FAMILIES[spec["family"]]
        steps = steps_of(ranges[ri])
        more = (shared,) if issubclass(cls, _Matrix) else extra.get(cls, ())
        fams[(name, ri)] = cls(spec, steps, cfg, labels, *more)
    by_range: dict[int, set] = {}
    for (name, ri), fam in fams.items():
        by_range.setdefault(ri, set()).update(fam.needs())
    for r0, cols in data.columns(cfg, seed, device):
        for ri, keys in by_range.items():
            steps = steps_of(ranges[ri])
            mats = {key: range_fn(cols[key[0]], key[1], cfg, steps, key[2],
                                  dtype) for key in keys}
            for (name, rj), fam in fams.items():
                if rj == ri:
                    fam.fold(r0, mats)
    return fams
