"""K3: the streaming pass of the port's bench, its roofline.

Port of ``bench.py::stream_probe``, the Pallas kernel that streams the
bench's [S, C] f32 value store once: it sums each (512, C) row tile over its
rows and adds the first 128 column sums into an (8, 128) accumulator,
broadcast over its 8 rows. The last S % 512 rows belong to no tile and are
not read. What it computes matters less than what it reads: every byte of
every counted row, once, so its time is the pass this card actually reaches
over the store, the floor under any query that reads the store once.

Two implementations of one function, chosen by the tensor's device:

  * K3, ``csrc/streamprobe.cu``: the hand-written CUDA kernel for Hopper.
    CUDA tensors launch it (or raise); nothing falls back.
  * :func:`stream_probe_plain`: per-tile column sums folded in tile order,
    in plain PyTorch. CPU tensors take it; on the card it is the kernel's
    yardstick only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels

TILE_ROWS = 512          # rows per tile (the reference's Sb)
OUT_SHAPE = (8, 128)     # the reference's accumulator block
MAP_BLOCKS = 1024        # about 4-8 map blocks per SM on a 132-SM card


def stream_probe_plain(val):
    """Plain PyTorch version of K3: the column sums of each whole 512-row
    tile of ``val`` [S, C] in f32, folded in tile order as the reference's
    grid accumulates them, first 128 columns broadcast to (8, 128)."""
    S, C = val.shape
    tiles = val[:S // TILE_ROWS * TILE_ROWS].reshape(-1, TILE_ROWS, C).sum(1)
    acc = torch.zeros(OUT_SHAPE[1], dtype=torch.float32, device=val.device)
    for t in tiles[:, :OUT_SHAPE[1]]:
        acc += t
    return acc.expand(OUT_SHAPE).clone()


@functools.lru_cache(maxsize=1)
def _k3_lib():
    lib = kernels.load("streamprobe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.streamprobe_launch.restype = i
    lib.streamprobe_launch.argtypes = [
        p, ctypes.c_longlong, i, i,              # val, row_stride, rows, cols
        i, i, i,                                 # per_block, nblocks, vec4
        p, p, p]                                 # scratch, out, stream
    lib.streamprobe_error_string.restype = ctypes.c_char_p
    lib.streamprobe_error_string.argtypes = [i]
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"stream_probe_kernel: {what}")


def k3_launch_shape(S: int) -> tuple[int, int]:
    """(whole tiles per map block, map blocks) of one K3 launch over S rows:
    about MAP_BLOCKS blocks, none of them empty."""
    tiles = S // TILE_ROWS
    per_block = -(-tiles // MAP_BLOCKS)
    return per_block, -(-tiles // per_block)


def vector_loads(val) -> bool:
    """K3 loads 4 columns at a time in 16-byte vectors: the width, the row
    stride and the base must allow it; otherwise it takes scalar loads."""
    return (val.shape[1] % 4 == 0 and val.stride(0) % 4 == 0
            and val.data_ptr() % 16 == 0)


def stream_probe_kernel(val):
    """Launch K3 on ``val``'s card; returns the (8, 128) f32 output.

    Checks what the kernel takes and raises ``ValueError`` on anything else,
    before any build or launch: ``val`` a CUDA float32 [S, C] tensor with
    unit column stride (any row stride), C >= 128, S >= 512. Launches on
    the current stream and does not synchronise. Counts its launches in
    ``.launches``.

    C interface (``streamprobe_launch`` in csrc/streamprobe.cu), in order:
    val, row_stride, rows (S), cols (C); tiles_per_block, nblocks (the map
    blocks of :func:`k3_launch_shape`), vec4 (:func:`vector_loads`);
    scratch ([nblocks, C] f32), out ((8, 128) f32), stream. It returns
    cudaGetLastError() after each of its two launches."""
    _require(val.dtype == torch.float32,
             f"val must be float32, got {val.dtype}")
    _require(val.dim() == 2 and val.stride(1) == 1,
             "val must be [S, C] with unit column stride")
    S, C = val.shape
    _require(C >= OUT_SHAPE[1], f"C={C} is below {OUT_SHAPE[1]} columns")
    _require(S >= TILE_ROWS, f"S={S} holds no whole {TILE_ROWS}-row tile")
    _require(val.is_cuda, "val must be a CUDA tensor")
    per_block, nblocks = k3_launch_shape(S)
    scratch = torch.empty((nblocks, C), dtype=torch.float32, device=val.device)
    out = torch.empty(OUT_SHAPE, dtype=torch.float32, device=val.device)
    lib = _k3_lib()
    # the <<<>>> launch runs on the thread's current device: make it val's
    with torch.cuda.device(val.device):
        err = lib.streamprobe_launch(
            val.data_ptr(), val.stride(0), S, C, per_block, nblocks,
            int(vector_loads(val)), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(val.device).cuda_stream)
    if err:
        why = lib.streamprobe_error_string(err).decode()
        raise RuntimeError(f"streamprobe kernel launch failed: CUDA error "
                           f"{err} ({why})")
    kernels.count_launch(stream_probe_kernel)
    return out


stream_probe_kernel.launches = 0


def stream_probe_sum(val):
    """The streaming pass over ``val`` [S, C] f32: K3 for CUDA tensors, the
    plain version for CPU tensors; there is no other route."""
    if val.is_cuda:
        return stream_probe_kernel(val)
    return stream_probe_plain(val)
