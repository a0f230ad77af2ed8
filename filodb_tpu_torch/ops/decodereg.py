"""Decode-variant registry of the fused tier.

Port of ``filodb_tpu/ops/decodereg.py``. The reference registers every
narrow-resident block format the fused kernels can stream; this slice of the
port streams the raw f32 store only, so ``raw`` is the one registered
variant. The narrow decodes (quant16, delta16, delta8) and the histogram
ones arrive with the residency slice; asking for them raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class DecodeVariant:
    """One block format the fused tier can stream: ``decode`` maps a value
    tile to f32; ``full_columns`` variants need the whole column prefix and
    bypass active-column slicing."""

    name: str
    decode: Callable
    full_columns: bool


DECODE_VARIANTS: dict[str, DecodeVariant] = {}


def register_variant(name: str, *, decode: Callable,
                     full_columns: bool) -> DecodeVariant:
    if name in DECODE_VARIANTS:
        raise ValueError(f"decode variant {name!r} already registered")
    v = DecodeVariant(name, decode, full_columns)
    DECODE_VARIANTS[name] = v
    return v


def variant(name: str) -> DecodeVariant:
    return DECODE_VARIANTS[name]


def decode_raw(v):
    """Raw f32 block: the tile as f32."""
    return v.float()


register_variant("raw", decode=decode_raw, full_columns=False)
