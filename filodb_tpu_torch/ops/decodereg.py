"""Decode-variant registry of the fused tier.

Port of ``filodb_tpu/ops/decodereg.py``: every block format K1 and its
plain twin can stream, with its decode in plain PyTorch. K1
(``csrc/fusedgrid.cu``) repeats each decode in its shared-memory staging;
the twin (``fusedgrid.fused_grid_aggregate_plain``) calls ``decode`` on
each [Sb, Ca] tile.

  name     block dtype  row operands      decode
  -------  -----------  ----------------  ---------------------------------
  raw      f32 [S,C]    —                 identity
  quant16  i16 [S,C]    vmin, scale       vmin + (q + 32768) * scale
  delta16  i16 [S,C]    anchor            anchor + cumsum(dv)  (full cols)
  delta8   i8  [S,C]    anchor            anchor + cumsum(dv)  (full cols)

``full_columns`` marks variants whose decode needs the whole column prefix
(the delta cumsum telescopes from cell 0): they bypass the active-column
slicing of ``fusedgrid.active_columns``. ``value_bytes`` is the block's
cost per sample. The histogram 2D-delta blocks are not registered: the
hist tier's one consumer (fusedresident.fused_hist_map_plain) widens the
i8/i16 tile itself, since its band products and bucket cumsums are the
decode.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class DecodeVariant:
    """One block format the fused tier can stream: ``decode`` maps a value
    tile and its ``row_operands`` per-row f32 side tensors ([Sb, 1] tiles)
    to f32."""

    name: str
    decode: Callable
    row_operands: int
    block_dtype: torch.dtype
    full_columns: bool
    value_bytes: int


DECODE_VARIANTS: dict[str, DecodeVariant] = {}

# the narrow variants of [S, C] scalar stores (a flush tries delta8, then
# quant16, then delta16: core/chunkstore.py::_prepare_scalar)
SCALAR_VARIANTS = ("quant16", "delta16", "delta8")


def register_variant(name: str, *, decode: Callable, row_operands: int,
                     block_dtype: torch.dtype, full_columns: bool,
                     value_bytes: int) -> DecodeVariant:
    if name in DECODE_VARIANTS:
        raise ValueError(f"decode variant {name!r} already registered")
    v = DecodeVariant(name, decode, row_operands, block_dtype, full_columns,
                      value_bytes)
    DECODE_VARIANTS[name] = v
    return v


def variant(name: str) -> DecodeVariant:
    return DECODE_VARIANTS[name]


def decode_raw(v):
    """Raw f32 block: the tile as f32."""
    return v.float()


def decode_quant16(q, vmin, scale):
    """quant16 (ops/narrow.build_narrow): the biased i16 block stores
    q - 32768 for q = round((v - vmin) / scale) in [0, 65535]; q * scale is
    exact (q < 2^16, power-of-two scale), so vmin + q * scale rebuilds the
    f32 value bit for bit on rows the encoder marked ok. The reference's
    order of operations, one rounding each."""
    return vmin + (q.float() + 32768.0) * scale


def decode_delta(dv, anchor):
    """delta16 / delta8 (ops/narrow.build_narrow_delta): the row's f32
    anchor plus the prefix sum of its integer deltas. The encoder admits
    only rows whose every prefix is within 2^23, so any summation order
    gives the same integers and the one rounding is the final add."""
    return anchor + torch.cumsum(dv.float(), dim=1)


register_variant("raw", decode=decode_raw, row_operands=0,
                 block_dtype=torch.float32, full_columns=False, value_bytes=4)
register_variant("quant16", decode=decode_quant16, row_operands=2,
                 block_dtype=torch.int16, full_columns=False, value_bytes=2)
register_variant("delta16", decode=decode_delta, row_operands=1,
                 block_dtype=torch.int16, full_columns=True, value_bytes=2)
register_variant("delta8", decode=decode_delta, row_operands=1,
                 block_dtype=torch.int8, full_columns=True, value_bytes=1)
