"""Narrow (compressed) residency encoders of the port.

Port of the histogram half of ``filodb_tpu/ops/narrow.py`` (ref: the wire
codec's 2D-delta, doc/compression.md "Histograms"). Buckets are cumulative,
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

The scalar encoders (quant16, delta16, delta8) come with the scalar
residency slice.
"""

from __future__ import annotations

import torch

# rows per block of the streaming build: a whole-store pass at 2^17 x 320 x
# 32 would hold several [S, C, B] f32 temporaries (5 GB each) at once
BUILD_BLOCK_BYTES = 256 << 20


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

    The pass runs in row blocks (``BUILD_BLOCK_BYTES`` of f32 per block):
    its temporaries stay a few hundred MB whatever the store's size."""
    S, C, B = val.shape
    rows = max(1, BUILD_BLOCK_BYTES // max(C * B * 4, 1))
    if rows >= S:
        return _build_hist_block(val, n)
    dev = val.device
    dd = torch.empty((S, C, B), dtype=torch.int16, device=dev)
    first_d = torch.empty((S, B), dtype=torch.float32, device=dev)
    flags = [torch.empty(S, dtype=torch.bool, device=dev) for _ in range(4)]
    for i in range(0, S, rows):
        j = min(i + rows, S)
        out = _build_hist_block(val[i:j], n[i:j])
        dd[i:j] = out[0]
        first_d[i:j] = out[1]
        for f, o in zip(flags, out[2:]):
            f[i:j] = o
    return (dd, first_d, *flags)


def cast_narrow_hist_i8(dd16):
    """i16 -> i8 narrowing for stores whose ok rows all fit 8 bits (pool rows
    may wrap — their dd is never read; decodes overlay the pool row-wise)."""
    return dd16.to(torch.int8)
