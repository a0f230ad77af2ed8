"""Narrow (compressed) residency encoders of the port.

Port of ``filodb_tpu/ops/narrow.py``, its ``NarrowMirror`` (an optional
quant16 copy beside a raw f32 store, rebuilt at flush) included.

Histogram stores (ref: the wire codec's 2D-delta, doc/compression.md
"Histograms"). Buckets are cumulative,
so the bucket-axis delta d[s,c,:] is small and non-negative, and the
time-axis delta of THOSE (dd) is near zero for quiet series. The resident
form keeps dd as i8/i16 [S, C, B] plus each row's first-frame bucket deltas
f32 [S, B]; the f32 block reconstructs as v = cumsum_b(first_d +
cumsum_c dd). Every reduction over the time axis the query kernels need
commutes with the bucket cumsum, so queries read the narrow dd block
directly (ops/gridfns.py *_narrow, K2) and the whole-store f32 block never
exists.

Losslessness contract: a row is ``ok`` only when the dd AS STORED — the
integer the block holds — rebuilds every valid cell bit-exactly in f32.
The reference checks the round trip on the unrounded f32 dd and then
truncates it into int16, so rows of non-integer counts pass its check and
are stored wrong; here the truncated dd is what the check rebuilds from,
and such rows fail and keep raw f32 in the cohort pool.

Scalar stores (gauges, counters) have two forms:

- quant16 (:func:`build_narrow`): per row a power-of-two ``scale`` and
  ``vmin``; the block stores q = round((v - vmin) / scale) in [0, 65535]
  biased by -32768 as i16, decoded as vmin + (q + 32768) * scale.
- delta16 / delta8 (:func:`build_narrow_delta`): per row an f32 ``anchor``
  (the first valid value) and integer per-step deltas as i16 (or i8 after
  :func:`cast_narrow_delta_i8`), decoded as anchor + cumsum(dv). A
  counter's values are large but its increments small, so this form
  carries counters quant16 cannot.

Float-to-integer casts saturate, NaN to 0, as XLA's convert does (PyTorch's
own cast wraps or is undefined out of range): the stored blocks then equal
the reference's bit for bit, pool rows included — but for quant16 rows
whose scale the reference's exp2 gets inexact (see _build_narrow_block).
"""

from __future__ import annotations

import torch

# rows per block of the streaming build: a whole-store pass at 2^17 x 320 x
# 32 would hold several [S, C, B] f32 temporaries (5 GB each) at once, and
# one at 2^20 x 768 several [S, C] f32 temporaries (3.2 GB each)
BUILD_BLOCK_BYTES = 256 << 20


def _to_i16(x):
    """f32 -> i16 the way XLA converts: saturating, NaN to 0."""
    return torch.nan_to_num(x, nan=0.0).clamp(-32768.0, 32767.0).to(torch.int16)


def _blocked(build, val, n):
    """Run the one-block ``build(val, n)`` over row blocks of
    ``BUILD_BLOCK_BYTES`` of f32 each: its temporaries stay a few hundred MB
    whatever the store's size. Every output is row-major in S."""
    S = val.shape[0]
    rows = max(1, BUILD_BLOCK_BYTES // max(val[0].numel() * 4, 1))
    if rows >= S:
        return build(val, n)
    outs = None
    for i in range(0, S, rows):
        j = min(i + rows, S)
        parts = build(val[i:j], n[i:j])
        if outs is None:
            outs = tuple(torch.empty((S,) + p.shape[1:], dtype=p.dtype,
                                     device=p.device) for p in parts)
        for o, p in zip(outs, parts):
            o[i:j] = p
    return outs


def _build_narrow_block(val, n):
    """One row block of :func:`build_narrow`."""
    f32 = torch.float32
    C = val.shape[1]
    valid = torch.arange(C, device=val.device)[None, :] < n[:, None]
    big = 3.4e38
    v = val.to(f32)
    vmin = torch.where(valid, v, big).amin(dim=1)
    vmax = torch.where(valid, v, -big).amax(dim=1)
    empty = ~valid[:, 0]
    vmin = torch.where(empty, 0.0, vmin)
    vmax = torch.where(empty, 0.0, vmax)
    span = vmax - vmin
    # smallest power-of-two scale with span / scale <= 65535:
    # scale = 2^ceil(log2(span / 65535)); span 0 -> scale 1. The reference's
    # expression, with its rounding: XLA compiles the division by the
    # constant as a product with the constant's f32 reciprocal, so one ulp
    # above span = 65535 * 2^k the reference's quotient is exactly 2^k (a
    # true division gives 2^k + 1 ulp, and the next power of two). The
    # product rounds alike on the CPU and the card
    # (tests/test_torch_scalar_residency.py holds the spans at 65535 * 2^k
    # and one ulp either side against the reference)
    recip = torch.full((), 1.0 / 65535.0, dtype=f32, device=v.device)
    exp = torch.ceil(torch.log2(torch.clamp(span, min=1e-37) * recip))
    # exact powers of two; XLA's CPU exp2 is exact only for a few exponents
    # (-14, -12..12, ...), so off them the reference's scale differs
    scale = torch.exp2(torch.clamp(exp, min=-126.0))
    scale = torch.where(span > 0, scale, 1.0)
    d = v - vmin[:, None]
    q = torch.clamp(torch.round(d / scale[:, None]), 0.0, 65535.0)
    recon = vmin[:, None] + q * scale[:, None]
    ok = torch.where(valid, recon == v, True).all(dim=1)
    return _to_i16(q - 32768.0), vmin, scale, ok


def build_narrow(val, n):
    """quant16 encoder over an [S, C] block: (q i16[S, C], vmin f32[S],
    scale f32[S], ok bool[S]).

    scale is the smallest power of two with (vmax - vmin) / scale <= 65535
    (a power of two makes q * scale exact); ``ok`` rows round-trip every
    valid cell bit for bit. Rows with no valid sample are ok with scale 1.
    The pass runs in row blocks (``BUILD_BLOCK_BYTES`` of f32 each)."""
    return _blocked(_build_narrow_block, val, n)


def _build_delta_block(val, n):
    """One row block of :func:`build_narrow_delta`."""
    f32 = torch.float32
    C = val.shape[1]
    col = torch.arange(C, device=val.device)[None, :]
    valid = col < n[:, None]
    v = val.to(f32)
    anchor = torch.where(valid[:, 0], v[:, 0], 0.0)
    d = torch.diff(v, dim=1, prepend=torch.zeros_like(v[:, :1]))
    pair = valid & (col > 0)
    dvq = torch.where(pair, torch.round(d), 0.0)
    integral = torch.where(pair, d == dvq, True).all(dim=1)
    # the round trip through the decode's own reduction
    prefix = torch.cumsum(dvq, dim=1)
    recon = anchor[:, None] + prefix
    exact = torch.where(valid, recon == v, True).all(dim=1)
    # every prefix within 2^23 of the anchor: every partial sum of any
    # summation order is then an integer exact in f32, so a decode may
    # scan in any order (K1 scans 32 cells at a time with a carry)
    bound = torch.where(valid, prefix.abs() <= 8388608.0, True).all(dim=1)
    ok_rt = integral & exact & bound
    fit16 = ((dvq >= -32768.0) & (dvq <= 32767.0)).all(dim=1)
    fit8 = ((dvq >= -128.0) & (dvq <= 127.0)).all(dim=1)
    return _to_i16(dvq), anchor, ok_rt & fit16, ok_rt & fit8, integral


def build_narrow_delta(val, n):
    """delta encoder over an [S, C] block: (dv i16[S, C], anchor f32[S],
    ok16 bool[S], ok8 bool[S], integral bool[S]).

    anchor is each row's first valid value; dv[:, 0] = 0 and dv is zero
    beyond the valid count, so ``anchor + cumsum(dv)`` extends the last
    value constantly (consumers mask by ``n``). ``okN`` rows round-trip
    bit for bit, keep every prefix within 2^23 and fit N-bit deltas;
    ``integral`` says whether a row's deltas were integers at all (the
    decline reason). Runs in row blocks like :func:`build_narrow`."""
    return _blocked(_build_delta_block, val, n)


def cast_narrow_delta_i8(dv16):
    """i16 -> i8 narrowing when every ok row fits 8 bits; pool rows wrap
    (their dv is never read: decodes take the pool row instead)."""
    return dv16.to(torch.int8)


def _build_hist_block(val, n):
    """One row block of :func:`build_narrow_hist`."""
    f32 = torch.float32
    S, C, _B = val.shape
    col = torch.arange(C, device=val.device)[None, :]
    valid = col < n[:, None]
    v = torch.where(valid[:, :, None], val.to(f32), 0.0)
    d = torch.diff(v, dim=2, prepend=torch.zeros_like(v[:, :, :1]))
    first_d = d[:, 0, :].contiguous()
    dd = torch.diff(d, dim=1, prepend=torch.zeros_like(d[:, :1, :]))
    pair = (valid & (col > 0))[:, :, None]
    dd = torch.where(pair, dd, 0.0)
    # the stored integer: truncation toward zero, as the int16 cast does;
    # non-finite deltas store 0 (such rows fail the monotone leg below)
    dq = torch.where(torch.isfinite(dd), torch.trunc(dd), 0.0)
    dq = torch.clamp(dq, -32768.0, 32767.0)
    # bit-exact round trip from the stored dd: integer components stay
    # exact through both cumsums while every partial sum is f32-exact
    v_rec = torch.cumsum(first_d[:, None, :] + torch.cumsum(dq, dim=1), dim=2)
    exact = torch.where(valid[:, :, None], v_rec == v, True)
    exact_row = exact.all(dim=2).all(dim=1)
    # counter-reset detection: any negative per-step bucket increment
    # (inc = cumsum_b dd) disqualifies the row — the raw rate kernels clamp
    # it, the telescoped narrow products cannot
    inc = torch.cumsum(dd, dim=2)
    mono_row = torch.where(pair, inc >= 0.0, True).all(dim=2).all(dim=1)
    in16 = (dd >= -32768.0) & (dd <= 32767.0)
    in8 = (dd >= -128.0) & (dd <= 127.0)
    fit16 = in16.all(dim=2).all(dim=1)
    fit8 = in8.all(dim=2).all(dim=1)
    ok_rt = exact_row & mono_row
    return (dq.to(torch.int16), first_d, ok_rt & fit16, ok_rt & fit8,
            mono_row, exact_row)


def build_narrow_hist(val, n):
    """Streaming pass over a [S, C, B] cumulative-bucket block:
    (dd i16[S, C, B], first_d f32[S, B], ok16 bool[S], ok8 bool[S],
    mono bool[S], exact bool[S]).

    ``mono``/``exact`` report the monotonicity and round-trip legs of the
    contract separately so a declining store can say why (counter resets vs
    non-integer data vs out-of-range deltas). ``okN`` marks rows that both
    round-trip bit-exactly from their stored dd, stay monotone over time,
    and whose dd fits the N-bit signed range. dd is zero at cell 0 (the
    first frame lives in ``first_d``) and beyond each row's valid count, so
    decodes extend the last frame constantly — consumers mask by ``n``.

    The pass runs in row blocks (``BUILD_BLOCK_BYTES`` of f32 per block)."""
    return _blocked(_build_hist_block, val, n)


def cast_narrow_hist_i8(dd16):
    """i16 -> i8 narrowing for stores whose ok rows all fit 8 bits (pool rows
    may wrap — their dd is never read; decodes overlay the pool row-wise)."""
    return dd16.to(torch.int8)


class NarrowMirror:
    """quant16 mirror of a raw f32 store's [S, C] value block, rebuilt at
    flush time outside the shard lock (the build streams the whole store
    and copies the per-row ok flags to the host, which must never hold up
    queries or ingest waiting on the lock) and only consulted by the query
    leaf. The mirror is current while the store's epoch (samples appended
    plus 1_000_003 per compaction, the reference's count) has not moved."""

    def __init__(self):
        self._epoch = -1
        self._data = None

    @staticmethod
    def _store_epoch(store) -> int:
        return (store.stats.samples_appended
                + store.stats.compactions * 1_000_003)

    def refresh(self, store) -> None:
        """(Re)build if the store mutated since the last build. Call outside
        the shard lock (flush time): one streaming pass, one host copy."""
        if (store.dtype != torch.float32 or store.val is None
                or store.val.dim() != 2):
            return
        epoch = self._store_epoch(store)
        if self._data is None or self._epoch != epoch:
            q, vmin, scale, ok = build_narrow(store.val, store.n)
            self._data = (q, vmin, scale, ok.cpu().numpy())
            self._epoch = epoch

    def get(self, store):
        """(q, vmin, scale, ok_host) when a current mirror exists, else
        None; never builds (query leaves run under the shard lock)."""
        if self._data is None or self._epoch != self._store_epoch(store):
            return None
        return self._data
