"""Clean twin of bad_decode_variant: every registered variant passes a
real plain decode= twin, and the registered names are exactly the keys of
KIND_CODES."""

KIND_CODES = {"raw": 0, "quant16": 1, "delta16": 2, "delta8": 3}


def register_variant(name, **kw):
    return name, kw


def decode_raw(v):
    return v.float()


def decode_quant16(q, vmin, scale):
    return vmin + (q.float() + 32768.0) * scale


def decode_delta(dv, anchor):
    return anchor + dv.float().cumsum(1)


register_variant("raw", decode=decode_raw, row_operands=0)
register_variant("quant16", decode=decode_quant16, row_operands=2)
register_variant("delta16", decode=decode_delta, row_operands=1)
register_variant("delta8", decode=decode_delta, row_operands=1)
