"""K1's quant16 staging: the ring, its flat layout, the dequantise.

``csrc/fusedgrid.cu`` stages a quant16 tile as it is stored, in a
two-stage ring of the block's own i16: the packed tile is cut into chunks
of one copy each (cw / 2 cells), chunk u goes to thread u % 256 in pass
u // 256, and each thread dequantises the chunks it copied,
``vmin + ((float)q + 32768) * scale`` a cell, into the f32 tile. The kernel
runs only on the card (chip_smoke.py holds it bit for bit against K1 raw
on the decoded block); here, as arithmetic:

* the layout ``ops/fusedgrid.py::k1_quant16_chunks`` mirrors covers every
  cell of every staged row exactly once, one row's cells a chunk, at every
  tile the launch shape can give and every copy width a row allows, and a
  thread dequantises exactly the cells it copied;
* a quarter warp's 16-byte f32 stores hit eight different bank groups;
* the copy width divides the view's first active byte, its row stride and
  its row length at every active column range;
* the ring fits: a quant16 block asks for exactly raw's shared memory, and
  ``k1_smem_bytes`` is the CUDA source's sum;
* a torch model of the dequantise over that layout equals the plain twin's
  ``decodereg.decode_quant16`` and the JAX package's
  ``filodb_tpu/ops/decodereg.py::decode_quant16`` bit for bit (NaN where
  they are NaN), on rows at the encoder's edges and on cohort-pool rows;
* the build log can name quant16's registers and spills.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import decodereg as jdr
from filodb_tpu_torch.ops import decodereg, kernels, narrow
from filodb_tpu_torch.ops import fusedgrid as fg

CU = os.path.join(os.path.dirname(fg.__file__), "csrc", "fusedgrid.cu")
H100_SMEM_OPT_IN = 232_448      # bytes a block may opt into (227 KB)
GROUPS = tuple(range(8, fg.MAX_GROUPS + 1, 8))
STEPS = tuple(range(fg.K1_STEPS, fg.MAX_STEPS + 1, fg.K1_STEPS))
ROWS = (8, 16, 120, 504, 512, 1024, 4096, 66048, 1 << 20)
# bench.py's 768, C not a multiple of 8 cells (1000: 8-byte copies; 1004:
# 8; 1001: plain loads), a chunk as wide as the row (8), the cap
COLUMNS = (8, 128, 768, 1000, 1001, 1004, fg.MAX_CAPACITY)
WIDTHS = (16, 8, 4, 2)
BASE = 0x7F00_0000_0000          # an allocation's start: 256-byte aligned


def launch_rts(Ca: int) -> set:
    """Every rows-a-tile k1_launch_shape gives at Ca columns."""
    return {fg.k1_launch_shape(S, Ca, Tp, G, nout)[0]
            for S in ROWS for Tp in STEPS for G in GROUPS for nout in (2, 3)}


def dequant_cells(Ca: int, nr: int, cw: int):
    """The dequantise's side of the layout, as ``dequant_quant16`` walks it:
    (pass, thread) -> the packed first cell it reads from the stage and
    writes to the f32 tile."""
    e = cw // 2
    out = {}
    for t in range(fg.K1_THREADS):
        ps, x = 0, t * e
        while x < nr * Ca:
            out[ps, t] = x
            ps, x = ps + 1, x + fg.K1_THREADS * e
    return out


@pytest.mark.parametrize("Ca", COLUMNS)
def test_the_layout_covers_every_cell_once_and_dequantises_what_it_copied(
        Ca):
    for cw in (w for w in WIDTHS if 2 * Ca % w == 0):
        e = cw // 2
        for rt in sorted(launch_rts(Ca)):
            for nr in range(1, rt + 1):          # every short last tile too
                seen = np.zeros((nr, Ca), np.int32)
                copied = {}
                for ps, t, x, r, c in fg.k1_quant16_chunks(Ca, nr, cw):
                    assert 0 <= t < fg.K1_THREADS and (ps, t) not in copied
                    copied[ps, t] = x
                    assert x == (ps * fg.K1_THREADS + t) * e
                    # one row's cells, where the packed tile has them
                    assert 0 <= r < nr and 0 <= c and c + e <= Ca
                    assert x == r * Ca + c
                    # the stage and the f32 tile aligned to the copy and
                    # to the store
                    assert 2 * x % cw == 0 and 4 * x % min(4 * e, 16) == 0
                    seen[r, c:c + e] += 1
                assert (seen == 1).all(), (Ca, cw, rt, nr)
                assert copied == dequant_cells(Ca, nr, cw), (Ca, cw, nr)


def test_the_passes_a_tile_need_no_row_operand_loads_at_16_bytes():
    """stage_quant16_async loads the vmin and scale of passes 0 and 1 a tile
    ahead; at 16-byte copies no fusable tile needs a third pass."""
    for Ca in range(8, fg.MAX_CAPACITY + 1, 8):
        for rt in {fg.k1_launch_shape(4096, Ca, fg.K1_STEPS, G, 3)[0]
                   for G in (8, fg.MAX_GROUPS)}:
            assert rt * Ca <= 2 * fg.K1_THREADS * 8, (Ca, rt)


@pytest.mark.parametrize("e", (8, 4, 2, 1))
def test_a_quarter_warps_stores_hit_different_bank_groups(e):
    """The f32 stores of one warp's chunks, as ``dequant_quant16`` issues
    them: an 8-cell chunk is two 16-byte stores, lanes 4-7 of each quarter
    warp writing their second half first; a 4-cell chunk one 16-byte store.
    Each store instruction's quarter warp (half warp for 8-byte stores,
    whole warp for 4-byte ones) must touch each bank at most once."""
    lanes = np.arange(32)
    x = lanes * e                               # packed first cell
    if e == 8:
        h = (lanes >> 2) & 1
        stores = [4 * x + 16 * h, 4 * x + 16 * (h ^ 1)]
        width, group = 16, 8
    elif e == 4:
        stores, width, group = [4 * x], 16, 8
    elif e == 2:
        stores, width, group = [4 * x], 8, 16
    else:
        stores, width, group = [4 * x], 4, 32
    for addr in stores:
        for g0 in range(0, 32, group):
            banks = [(a // 4 + k) % 32 for a in addr[g0:g0 + group]
                     for k in range(width // 4)]
            assert len(banks) == len(set(banks)) == 32, (e, g0, banks)


def active_ranges(C: int) -> set:
    """Every (c0, Ca) active_columns gives at C over window edges a
    multiple of 4 cells apart (and at both ends)."""
    edges = sorted(set(range(0, C, 4)) | {C - 1})
    out = set()
    for i, first in enumerate(edges):
        for last in edges[i:]:
            out.add(fg.active_columns(C, np.array([first]),
                                      np.array([last])))
    return out


@pytest.mark.parametrize("C", range(128, fg.MAX_CAPACITY + 1, 128))
def test_the_copy_width_divides_the_first_active_byte_stride_and_row(C):
    ranges = active_ranges(C)
    # past one 128-column block some ranges start at c0 > 0
    assert (0, C) in ranges and (C == 128 or any(c0 for c0, _ in ranges))
    for c0, Ca in ranges:
        assert Ca % 128 == 0 and c0 % Ca == 0 and c0 + Ca <= C
        for base in (BASE, BASE + 2 * C):        # the block, a view from row 1
            first = base + 2 * c0
            w = fg.delta_copy_width(first, 2 * C, 2 * Ca)
            assert first % w == (2 * C) % w == (2 * Ca) % w == 0
            assert w == 16, (C, c0, Ca, base)


@pytest.mark.parametrize("C,want", ((768, 16), (1000, 16), (1004, 8),
                                    (1001, 2), (136, 16), (8, 16)))
def test_the_wrappers_copy_width_of_a_block_and_its_views(C, want):
    """k1_copy_width on real i16 tensors: the block, a view from row 1 and
    (C % 128 == 0 only) active columns from c0 > 0."""
    q = torch.zeros((5, C), dtype=torch.int16)
    assert q.data_ptr() % 16 == 0
    got = fg.k1_copy_width(q, 0, C)
    assert got == want
    view = q[1:]
    w1 = fg.k1_copy_width(view, 0, C)
    assert w1 == min(want, (2 * C) & -(2 * C), 16)
    for t, c0, Ca in ((q, 0, C), (view, 0, C)):
        w = fg.k1_copy_width(t, c0, Ca)
        first = t.data_ptr() + 2 * c0
        assert first % w == 2 * t.stride(0) % w == 2 * Ca % w == 0
    big = torch.zeros((3, 1024), dtype=torch.int16)
    assert fg.k1_copy_width(big, 512, 512) == 16
    assert fg.k1_copy_width(big[1:], 768, 256) == 16


# ---- shared memory: the CUDA source's sum, evaluated ----------------------

def c_to_py(expr: str) -> str:
    """A C integer expression of the source as Python: casts and sizeof
    resolved, ?: nested to the right, || and && as or / and, / as //."""
    expr = re.sub(r"\(size_t\)", "", expr)
    expr = expr.replace("sizeof(float)", "4").replace("sizeof(int)", "4")
    expr = expr.replace("||", " or ").replace("&&", " and ")
    expr = re.sub(r"(?<![/])/(?![/])", "//", expr)
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:
        return expr
    depth, nest = 0, 0
    for j in range(q + 1, len(expr)):
        ch = expr[j]
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if nest == 0:
                break
            nest -= 1
    return (f"(({c_to_py(expr[q + 1:j])}) if ({c_to_py(expr[:q])}) "
            f"else ({c_to_py(expr[j + 1:])}))")


def source_smem():
    """smem_bytes(kind, rt, ca, groups, nout) of csrc/fusedgrid.cu, with
    its tile_buffers and ring_bytes, as Python functions."""
    with open(CU) as f:
        src = f.read()
    env = {}
    for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src):
        env[m.group(1)] = int(m.group(2))
    for m in re.finditer(r"(KIND_\w+) = (\d+),", src):
        env[m.group(1)] = int(m.group(2))
    for name, args in (("tile_buffers", "kind"),
                       ("ring_bytes", "kind, rt, ca"),
                       ("smem_bytes", "kind, rt, ca, groups, nout")):
        m = re.search(rf"\b{name}\([^)]*\) \{{\s*return (.*?);\s*\}}", src,
                      re.S)
        assert m is not None, name
        body = " ".join(m.group(1).split())
        exec(f"def {name}({args}):\n    return {c_to_py(body)}\n", env)
    return env["smem_bytes"], env


@pytest.mark.parametrize("nout", (2, 3))
@pytest.mark.parametrize("G", GROUPS)
def test_the_quant16_ring_takes_exactly_raws_shared_memory(G, nout):
    smem, env = source_smem()
    codes = fg.KIND_CODES
    for Ca in range(1, fg.MAX_CAPACITY + 1):
        rt = fg.k1_launch_shape(4096, Ca, fg.K1_STEPS, G, nout)[0]
        raw = fg.k1_smem_bytes(Ca, rt, G, nout, "raw")
        q16 = fg.k1_smem_bytes(Ca, rt, G, nout, "quant16")
        assert q16 == raw <= H100_SMEM_OPT_IN, (Ca, G, nout)
        # the ring's two i16 stages beside the one f32 tile
        assert env["ring_bytes"](codes["quant16"], rt, Ca) == 4 * rt * Ca
        assert env["tile_buffers"](codes["quant16"]) == 1
        for kind, code in codes.items():
            assert smem(code, rt, Ca, G, nout) == \
                fg.k1_smem_bytes(Ca, rt, G, nout, kind), (kind, Ca, G)


def test_quant16_launches_the_entry_held_to_four_blocks_an_sm():
    """quant16 and the delta variants launch fused_grid_map_ring, bounded
    to four blocks of 256 threads an SM (64 registers); raw keeps
    fused_grid_map and its bound."""
    with open(CU) as f:
        src = f.read()
    assert re.search(r"__launch_bounds__\(kThreads, 4\)\s*"
                     r"fused_grid_map_ring\(Params p\)", src)
    assert re.search(r"__launch_bounds__\(kThreads\)\s*"
                     r"fused_grid_map\(Params p\)", src)
    m = re.search(r"if constexpr \(K == KIND_RAW\)\s*kernel = "
                  r"fused_grid_map<K>;\s*else\s*kernel = "
                  r"fused_grid_map_ring<K>;", src)
    assert m is not None
    # nothing stages quant16 synchronously any more
    assert "stage_quant16(" not in src and "stage_quant16_async(" in src


# ---- the dequantise's arithmetic, modelled in torch -----------------------

def model_dequant(q: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
                  rt: int, cw: int) -> torch.Tensor:
    """The kernel's dequantise of an [S, C] quant16 block, tile by tile,
    over its layout: each chunk's cells with the vmin and scale of the row
    its (row, column) names, ``vmin + ((float)q + 32768) * scale`` in f32,
    one rounding an operation, written at the chunk's packed cell."""
    f32 = torch.float32
    S, C = q.shape
    out = torch.full((S * C,), float("nan"), dtype=f32)
    e = cw // 2
    for r0 in range(0, S, rt):
        nr = min(rt, S - r0)
        packed = q[r0:r0 + nr].reshape(-1)
        for _ps, _t, x, r, c in fg.k1_quant16_chunks(C, nr, cw):
            cells = packed[x:x + e].to(f32)
            a = cells + torch.tensor(32768.0, dtype=f32)
            b = a * scale[r0 + r]
            out[r0 * C + x:r0 * C + x + e] = vmin[r0 + r] + b
    return out.reshape(S, C)


def edge_rows(C: int, seed: int):
    """(q i16 [S, C], vmin f32 [S], scale f32 [S]) of 64 rows. Rows 0-24:
    the port's encoder on rows whose span is exactly 65535 * 2^k, k in
    [-12, 12] (inside XLA's exact exponents), each reaching q = 0 and
    q = 65535 (i16 -32768 and 32767), at vmin of either sign and up to
    2^20; rows 25-31 short rows (n < C) and a row of one value; the rest
    cohort-pool rows: garbage q with NaN, +-Inf, huge or tiny (normal) vmin
    and scale, and finite ones whose add rounds."""
    rng = np.random.default_rng(seed)
    S = 64
    vals = np.zeros((S, C), np.float32)
    n = np.full(S, C, np.int32)
    for r, k in enumerate(range(-12, 13)):
        step = np.float32(2.0 ** k)
        qv = rng.integers(0, 65536, C)
        qv[0], qv[-1] = 0, 65535
        base = np.float32(rng.integers(-(1 << 20), 1 << 20)) * step \
            if k < 0 else np.float32(rng.integers(-(1 << 20), 1 << 20))
        vals[r] = base + qv.astype(np.float32) * step
    for r in range(25, 32):
        qv = rng.integers(0, 65536, C)
        vals[r] = 1000.0 + 0.5 * qv
        n[r] = rng.integers(0, C + 1)
    vals[31] = 42.0
    q, vmin, scale, ok = narrow.build_narrow(torch.from_numpy(vals),
                                             torch.from_numpy(n))
    assert bool(ok[:32].all())
    q, vmin, scale = q.clone(), vmin.clone(), scale.clone()
    pool = torch.arange(32, S)
    q[pool] = torch.from_numpy(rng.integers(-32768, 32768, (len(pool), C))
                               .astype(np.int16))
    # no subnormal operand: XLA's CPU flushes them to zero, the card and
    # torch do not
    weird = [float("nan"), float("inf"), -float("inf"), 3.4e38, -1.5e-38,
             16777215.0, 0.1, -7.25]
    vmin[pool] = torch.tensor([weird[i % 8] for i in range(len(pool))])
    scale[pool] = torch.tensor([weird[(3 * i + 1) % 8]
                                for i in range(len(pool))])
    return q, vmin, scale


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-equal f32 arrays, NaN where the other is NaN."""
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a[~nan].view(np.uint32) == b[~nan].view(np.uint32)).all())


@pytest.mark.parametrize("C", (8, 136, 768, 1001, 1004))
def test_the_dequant_model_is_bit_for_bit_the_plain_and_jax_decode(C):
    """C = 768: 16-byte copies; 1004: 8-byte; 1001: plain 2-byte loads; 136
    and 8: many rows a tile, a chunk the whole row at 8."""
    q, vmin, scale = edge_rows(C, seed=C)
    rt = fg.k1_launch_shape(q.shape[0], C, 128, 8, 2)[0]
    cw = fg.delta_copy_width(BASE, 2 * C, 2 * C)
    got = model_dequant(q, vmin, scale, rt, cw).numpy()
    plain = decodereg.variant("quant16").decode(
        q, vmin[:, None], scale[:, None]).numpy()
    ref = np.asarray(jdr.decode_quant16(jnp.asarray(q.numpy()),
                                        jnp.asarray(vmin.numpy())[:, None],
                                        jnp.asarray(scale.numpy())[:, None]))
    assert got.dtype == plain.dtype == ref.dtype == np.float32
    assert same_bits(got, plain)
    assert same_bits(got, ref)
    # the edges were reached: ok rows decode to what was encoded at q = 0
    # and 65535, pool rows to NaN and Inf, and the pool's finite add rounds
    assert (q[:25, 0] == -32768).all() and (q[:25, -1] == 32767).all()
    assert np.isnan(got[32:]).any() and np.isinf(got[32:]).any()
    exact = (vmin.double()[:, None]
             + (q.double() + 32768.0) * scale.double()[:, None]).numpy()
    fin = np.isfinite(exact[32:]) & np.isfinite(got[32:])
    assert (got[32:][fin] != exact[32:][fin]).any()


def test_the_biased_value_needs_no_conversion_instruction():
    """``q_biased``: for every stored i16 q, the f32 whose bits are its 16
    bits XOR 0x4B008000, less 2^23, is exactly (float)q + 32768."""
    q = torch.arange(-32768, 32768, dtype=torch.int32)
    h = q & 0xFFFF
    f = (h ^ 0x4B008000).to(torch.int32).view(torch.float32)
    got = f - torch.tensor(8388608.0)
    want = q.to(torch.float32) + torch.tensor(32768.0)
    assert torch.equal(got, want)
    assert got.min() == 0 and got.max() == 65535
    with open(CU) as f:
        src = f.read()
    assert "__int_as_float(h ^ 0x4B008000u) - 8388608.f" in src


def test_the_build_log_names_each_entry_and_its_spills():
    """chip_smoke.py prints the build's registers and spills by kernel:
    ``kernels.ptxas_usage`` over an ``-Xptxas -v`` report."""
    report = "\n".join((
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119fused_grid_map_ringILi1EEEvNS_6ParamsE' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_119fused_grid_map_ringILi1EEEvNS_6ParamsE",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 8 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114fused_grid_mapILi0EEEvNS_6ParamsE' for "
        "'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_114fused_grid_mapILi0EEEvNS_6ParamsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z11fold_chunksPKfPfii' "
        "for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 0 barriers"))
    assert kernels.ptxas_usage(report) == [
        {"kernel": "fused_grid_map_ring<1>", "registers": 64,
         "spill_stores": 4, "spill_loads": 12},
        {"kernel": "fused_grid_map<0>", "registers": 48, "spill_stores": 0,
         "spill_loads": 0},
        {"kernel": "fold_chunks", "registers": 32, "spill_stores": 0,
         "spill_loads": 0}]
    assert kernels.ptxas_usage("Used 7 registers") == []
