"""The segment fold: the reference's ``segment_sum``, in row order.

The reference's map phase (``filodb_tpu/ops/aggregators.py``) folds rows
with ``jax.ops.segment_sum`` whenever ``stable=True`` or G > 64: each
group's rows in ROW ORDER, each output column on its own, so the answer
depends neither on the padded step bucket nor on row padding. This module
is that fold for ``aggregators.partial_aggregate``: per group and column
the f64 sum of the zeroed values (NaN -> 0), optionally the f64 sum of
their squares (squared in the values' own dtype), and the count of
present values, all [G, T] f64. Rows whose group id lies outside [0, G)
belong to no group.

Two implementations of one function:

  * :func:`segment_fold_kernel`, ``csrc/segfold.cu``: the hand-written
    CUDA kernel for Hopper. CUDA tensors launch it (or raise); nothing
    falls back. It adds in row order, so it gives the CPU twin's bits.
  * :func:`segment_fold_plain`: ``index_add_`` of the zeroed values. CPU
    tensors take it; there ``index_add_`` is a sequential loop in row
    order. On the card it is f64 atomics in no fixed order: a yardstick of
    time only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import kernels


def segment_fold_plain(values, gids, num_groups: int,
                       sumsq: bool = False) -> dict:
    """Plain PyTorch version of the fold: ``index_add_`` of the zeroed
    values (squares taken in the values' dtype) into f64 zeros, a spare
    group G for the out-of-range rows."""
    present = ~torch.isnan(values)
    zeroed = torch.where(present, values, 0.0)
    gids = gids.to(device=values.device, dtype=torch.int64)
    gids_in = torch.where((gids >= 0) & (gids < num_groups), gids,
                          num_groups)

    def gsum(x):
        out = torch.zeros((num_groups + 1,) + tuple(x.shape[1:]),
                          dtype=torch.float64, device=x.device)
        return out.index_add_(0, gids_in, x.to(torch.float64))[:num_groups]

    out = {"sum": gsum(zeroed), "count": gsum(present)}
    if sumsq:
        out["sumsq"] = gsum(zeroed * zeroed)
    return out


def group_rows(gids, num_groups: int):
    """The fold's row list on the gids' device: ``(order, offsets)``, the
    rows whose gid lies in [0, G) grouped by gid and ascending within a
    group (a stable sort; out-of-range rows sort past the last group), and
    the [G + 1] int64 bounds of each group's run in ``order``. No host
    synchronisation."""
    g = gids.to(torch.int64)
    key = torch.where((g >= 0) & (g < num_groups), g, num_groups).to(
        torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(num_groups + 1, dtype=torch.int32,
                                 device=gids.device))
    return order, offsets


@functools.lru_cache(maxsize=1)
def _lib():
    lib = kernels.load("segfold")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segfold_launch.restype = i
    lib.segfold_launch.argtypes = [
        p, i, ctypes.c_longlong,                 # values, is_f64, T
        p, p, i,                                 # order, offsets, G
        p, p, p, p]                              # sum, sumsq, count, stream
    lib.segfold_error_string.restype = ctypes.c_char_p
    lib.segfold_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"segment_fold_kernel: {what}")


def segment_fold_kernel(values, order, offsets, num_groups: int,
                        sumsq: bool = False) -> dict:
    """Launch the fold on ``values``' card over the row list of
    :func:`group_rows`; returns ``{"sum", "count"[, "sumsq"]}``, [G, T]
    f64 each.

    Checks what the kernel takes and raises ``ValueError`` on anything
    else, before any build or launch: ``values`` a contiguous CUDA [S, T]
    float32 or float64 tensor, ``order`` int64 [<= S] and ``offsets`` int64
    [G + 1] on its device. G = 0 or T = 0 gives empty outputs without a
    launch. Launches on the current stream and does not synchronise.
    Counts its launches in ``.launches``.

    C interface (``segfold_launch`` in csrc/segfold.cu), in order: values,
    is_f64, T; order, offsets, G; sum, sumsq (0 when not asked for), count,
    stream. It returns cudaGetLastError() after the launch."""
    _require(values.dtype in (torch.float32, torch.float64),
             f"values must be float32 or float64, got {values.dtype}")
    _require(values.dim() == 2 and values.is_contiguous(),
             "values must be a contiguous [S, T] tensor")
    _require(num_groups >= 0, f"G={num_groups} is negative")
    _require(order.dtype == torch.int64 and order.dim() == 1
             and order.shape[0] <= values.shape[0],
             "order must be int64 [<= S]")
    _require(offsets.dtype == torch.int64
             and tuple(offsets.shape) == (num_groups + 1,),
             f"offsets must be int64 [{num_groups + 1}]")
    _require(values.is_cuda, "values must be a CUDA tensor")
    _require(order.device == values.device
             and offsets.device == values.device,
             "order and offsets must lie on values' card")
    T = values.shape[1]
    shape = (num_groups, T)
    out = {"sum": torch.empty(shape, dtype=torch.float64,
                              device=values.device),
           "count": torch.empty(shape, dtype=torch.float64,
                                device=values.device)}
    if sumsq:
        out["sumsq"] = torch.empty_like(out["sum"])
    if T == 0 or num_groups == 0:
        return out
    lib = _lib()
    # the <<<>>> launch runs on the thread's current device: make it values'
    with torch.cuda.device(values.device):
        err = lib.segfold_launch(
            values.data_ptr(), int(values.dtype == torch.float64), T,
            order.data_ptr(), offsets.data_ptr(), num_groups,
            out["sum"].data_ptr(),
            out["sumsq"].data_ptr() if sumsq else None,
            out["count"].data_ptr(),
            torch.cuda.current_stream(values.device).cuda_stream)
    if err:
        why = lib.segfold_error_string(err).decode()
        raise RuntimeError(f"segfold kernel launch failed: CUDA error {err} "
                           f"({why})")
    kernels.count_launch(segment_fold_kernel)
    return out


segment_fold_kernel.launches = 0


def segment_fold(values, gids, num_groups: int, sumsq: bool = False) -> dict:
    """The row-order segment fold of ``values`` [S, ...] by ``gids`` [S]:
    ``{"sum", "count"[, "sumsq"]}``, [G, ...] f64 each. CUDA tensors launch
    the kernel (after :func:`group_rows` on the card), CPU tensors take the
    plain twin; there is no other route. Both fold the values flattened to
    [S, T] (S = 0 included)."""
    rest = tuple(values.shape[1:])
    flat = values.reshape(values.shape[0], math.prod(rest))
    if values.is_cuda:
        order, offsets = group_rows(gids.to(values.device), num_groups)
        out = segment_fold_kernel(flat.contiguous(), order, offsets,
                                  num_groups, sumsq)
    else:
        out = segment_fold_plain(flat, gids, num_groups, sumsq)
    return {k: v.reshape((num_groups,) + rest) for k, v in out.items()}
