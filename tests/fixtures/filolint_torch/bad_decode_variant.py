"""MUST flag surface-decode-variant-twin (the port's form): a variant
registered with decode=None, one registered with no decode= at all, one
registered with no code in KIND_CODES (the kernel cannot decode it), and a
kernel code with no registered plain twin."""

KIND_CODES = {"raw": 0, "quant16": 1, "delta8": 3, "delta4": 4}


def register_variant(name, **kw):
    return name, kw


def decode_raw(v):
    return v.float()


def decode_delta(dv, anchor):
    return anchor + dv.float().cumsum(1)


register_variant("raw", decode=decode_raw, row_operands=0)
# BAD: the placeholder the CPU twin would call and cannot run
register_variant("quant16", decode=None, row_operands=2)
# BAD: no plain twin at all
register_variant("delta8", row_operands=1)
# BAD: registered, but K1 has no code for it
register_variant("delta16", decode=decode_delta, row_operands=1)
# BAD (at KIND_CODES): "delta4" has a kernel code and no registration
