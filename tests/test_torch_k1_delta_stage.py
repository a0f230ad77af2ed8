"""K1's delta staging: the ring, the one-pass decode's layout and its sums.

``csrc/fusedgrid.cu`` stages a delta16 / delta8 tile as it is stored, in a
two-stage ring of the block's own i16 / i8, and decodes it into the f32
tile in one pass of the whole block: each thread sums a run of 16 cells of
one row in int32, a segmented scan over the block (rows are the segments)
gives each run the sum of its row's cells before it, and each cell becomes
``anchor + (float)prefix``. The kernel runs only on the card (chip_smoke.py
holds it bit for bit against K1 raw on the decoded block); here, as
arithmetic:

* the layout ``ops/fusedgrid.py::k1_delta_cells`` takes from the CUDA
  source's constants covers every cell of every staged row exactly once, in
  at most ``K1_PASSES`` passes, at every tile the launch shape can give;
* a torch model of the decode's order of additions (int32 run sums, the
  warp-shuffle segmented scan, the warps' carries, the anchor add) equals
  the plain twin's ``decodereg.decode_delta`` and the JAX package's
  ``filodb_tpu/ops/decodereg.py::decode_delta`` bit for bit (NaN where they
  are NaN) on rows at the encoder's edges, and on cohort-pool rows;
* the ring fits: no delta block asks for more shared memory than raw's;
* the copy width divides what it must.
"""

import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import decodereg as jdr
from filodb_tpu_torch.ops import decodereg, narrow
from filodb_tpu_torch.ops import fusedgrid as fg

CU = os.path.join(os.path.dirname(fg.__file__), "csrc", "fusedgrid.cu")
H100_SMEM_OPT_IN = 232_448      # bytes a block may opt into (227 KB)
DELTA_KINDS = ("delta16", "delta8")
GROUPS = tuple(range(8, fg.MAX_GROUPS + 1, 8))
STEPS = tuple(range(fg.K1_STEPS, fg.MAX_STEPS + 1, fg.K1_STEPS))
ROWS = (8, 16, 120, 504, 512, 1024, 4096, 66048, 1 << 20)
# the issue's columns: bench.py's 768, C not a multiple of 16 cells or of
# 16 bytes (1000, 1004), a run wider than the row (8), the cap
COLUMNS = tuple(dict.fromkeys((8, 128, 768, 1000, 1004, 1024,
                               fg.MAX_CAPACITY)))
DTYPES = {"delta16": torch.int16, "delta8": torch.int8}


def launch_rts(Ca: int) -> set:
    """Every rows-a-tile k1_launch_shape gives at Ca columns."""
    return {fg.k1_launch_shape(S, Ca, Tp, G, nout)[0]
            for S in ROWS for Tp in STEPS for G in GROUPS for nout in (2, 3)}


@pytest.mark.parametrize("name,value", (("kRun", fg.K1_RUN),
                                        ("kPasses", fg.K1_PASSES),
                                        ("kMaxRuns", fg.K1_MAX_RUNS),
                                        ("kThreads", fg.K1_THREADS)))
def test_the_cuda_source_has_the_decode_constants(name, value):
    with open(CU) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value, name


@pytest.mark.parametrize("Ca", COLUMNS)
def test_the_decode_layout_covers_every_cell_once(Ca):
    for rt in sorted(launch_rts(Ca)):
        nrun, rpp, passes = fg.k1_delta_runs(Ca, rt)
        assert rpp >= 1 and passes <= fg.K1_PASSES, (Ca, rt, rpp, passes)
        for nr in range(1, rt + 1):         # every short last tile too
            seen = np.zeros((nr, Ca), np.int32)
            threads = set()
            for ps, t, r, cs, ce in fg.k1_delta_cells(Ca, nr):
                assert 0 <= t < fg.K1_THREADS and (ps, t) not in threads
                threads.add((ps, t))
                assert 0 <= cs < ce <= Ca and ce - cs <= fg.K1_RUN
                # a run is one row's cells, and a row starts a run
                assert cs % fg.K1_RUN == 0
                seen[r, cs:ce] += 1
            assert (seen == 1).all(), (Ca, rt, nr)


def test_every_column_count_decodes_in_its_passes():
    """At every C a fusable block can have (not only the issue's), a row
    is at most K1_MAX_RUNS runs (so it spans at most three warps, and a
    run's carry comes from at most two warps back) and every tile decodes
    in at most K1_PASSES passes of whole rows: the kernel refuses a launch
    that would need more, so none may."""
    for Ca in range(1, fg.MAX_CAPACITY + 1):
        for G in (8, fg.MAX_GROUPS):
            rt = fg.k1_launch_shape(4096, Ca, fg.K1_STEPS, G, 3)[0]
            nrun, rpp, passes = fg.k1_delta_runs(Ca, rt)
            assert nrun * fg.K1_RUN >= Ca > (nrun - 1) * fg.K1_RUN
            assert nrun <= fg.K1_MAX_RUNS <= 2 * 32
            assert 1 <= rpp and rpp * nrun <= fg.K1_THREADS
            assert passes <= fg.K1_PASSES, (Ca, rt, passes)


@pytest.mark.parametrize("nout", (2, 3))
@pytest.mark.parametrize("G", GROUPS)
def test_the_ring_fits_within_raws_shared_memory(G, nout):
    for Ca in range(1, fg.MAX_CAPACITY + 1):
        rt = fg.k1_launch_shape(4096, Ca, fg.K1_STEPS, G, nout)[0]
        raw = fg.k1_smem_bytes(Ca, rt, G, nout, "raw")
        for kind in DELTA_KINDS:
            smem = fg.k1_smem_bytes(Ca, rt, G, nout, kind)
            assert smem <= raw and smem <= H100_SMEM_OPT_IN, (Ca, G, kind)
            # the ring's two stages of the block's own type, rounded to 4
            # bytes, beside one f32 tile (raw less its second buffer)
            esz = 2 if kind == "delta16" else 1
            ring = smem - (raw - 4 * rt * Ca)
            assert 2 * rt * Ca * esz <= ring <= 2 * rt * Ca * esz + 3


def test_the_launch_shape_does_not_depend_on_the_kind():
    """k1_launch_shape takes no decode variant: a narrow block and its
    decode fold in the same rows_per_block and chunks (bit for bit the
    same partials), and the delta staging changed neither."""
    assert "kind" not in inspect.signature(fg.k1_launch_shape).parameters
    assert fg.k1_launch_shape(1 << 20, 768, 128, 8, 2) == (5, 1024, 1024)
    for Ca in COLUMNS:
        for S in ROWS:
            rt, rows_per_block, nchunks = fg.k1_launch_shape(S, Ca, 128, 8, 2)
            assert rows_per_block * nchunks >= S
            # the one rt every variant stages decodes within its passes
            assert fg.k1_delta_runs(Ca, rt)[2] <= fg.K1_PASSES


@pytest.mark.parametrize("ptr,stride,row,want", (
    (0x7F00_0000_0000, 768, 768, 16),          # delta8 at bench.py's C
    (0x7F00_0000_0000, 1536, 1536, 16),        # delta16 at bench.py's C
    (0x7F00_0000_0000, 1004, 1004, 4),         # delta8, C = 1004
    (0x7F00_0000_0000, 2008, 2008, 8),         # delta16, C = 1004
    (0x7F00_0000_0000 + 1004, 1004, 1004, 4),  # a view from row 1
    (0x7F00_0000_0000 + 2008, 2008, 2008, 8),
    (0x7F00_0000_0000 + 768, 768, 768, 16),
    (0x7F00_0000_0000, 1001, 1001, 1),         # an odd-length i8 row
    (0x7F00_0000_0000 + 2, 2000, 2000, 2),     # i16 at an odd element
    (0x7F00_0000_0008, 1024, 1024, 8),
))
def test_the_copy_width_divides_base_stride_and_row(ptr, stride, row, want):
    w = fg.delta_copy_width(ptr, stride, row)
    assert w == want
    assert ptr % w == stride % w == row % w == 0
    assert w == 16 or any(x % (2 * w) for x in (ptr, stride, row))


# ---- the decode's order of additions, modelled in torch ---------------------

def model_decode(dv: torch.Tensor, anchor: torch.Tensor, rt: int):
    """The kernel's decode of an [S, C] delta block, tile by tile, with its
    layout and its order of operations: int32 run sums (a thread's run is
    16 cells, four groups of four), the segmented inclusive scan in shuffle
    steps of 1..16 within each warp (a lane adds the lane ``off`` back while
    both its run index in the row and its lane are at least ``off``), the
    carry of the last lane of each warp back to the one the row starts in
    (at most two), each cell's prefix from its group's start, then one f32
    add to the anchor."""
    i32 = torch.int32
    S, C = dv.shape
    out = torch.empty((S, C), dtype=torch.float32)
    lane = torch.arange(fg.K1_THREADS) % 32
    warp = torch.arange(fg.K1_THREADS) // 32
    for r0 in range(0, S, rt):
        nr = min(rt, S - r0)
        tile = dv[r0:r0 + nr].to(i32)
        runs = list(fg.k1_delta_cells(C, nr))
        for ps in sorted({x[0] for x in runs}):
            mine = [x for x in runs if x[0] == ps]
            v = torch.zeros(fg.K1_THREADS, dtype=i32)
            j = torch.zeros(fg.K1_THREADS, dtype=torch.int64)
            for _ps, t, r, cs, ce in mine:
                v[t] = tile[r, cs:ce].sum(dtype=i32)
                j[t] = cs // fg.K1_RUN
            s = v.clone()
            back = torch.minimum(j, lane)
            for off in (1, 2, 4, 8, 16):
                s = torch.where(back >= off, s + torch.roll(s, off), s)
            wsum = s[31::32]
            for _ps, t, r, cs, ce in mine:
                pre = s[t] - v[t]
                w0 = (t - int(j[t])) >> 5
                for w in (int(warp[t]) - 1, int(warp[t]) - 2):
                    if w0 <= w:
                        pre = pre + wsum[w]
                cells = tile[r, cs:ce]
                prefix = torch.empty_like(cells)
                for g in range(0, ce - cs, 4):
                    start = pre + cells[:g].sum(dtype=i32)
                    prefix[g:g + 4] = start + torch.cumsum(cells[g:g + 4], 0,
                                                           dtype=i32)
                out[r0 + r, cs:ce] = anchor[r0 + r] + prefix.to(torch.float32)
    return out


def edge_rows(kind: str, C: int, seed: int):
    """(dv [S, C], anchor [S]) of ``kind``: rows the port's encoder admits
    (short rows, rows of 0 and 1 samples), rows whose prefix reaches +-2^23
    (delta16; an i8 row cannot), non-integer anchors, values near 2^24
    whose anchor add rounds, and cohort-pool rows (any deltas, a NaN or Inf
    anchor). S = 64."""
    rng = np.random.default_rng(seed)
    S = 64
    hi = 127 if kind == "delta8" else 32767
    steps = rng.integers(0, 4 if kind == "delta8" else 3000, (S, C))
    val = np.cumsum(steps, axis=1) + rng.integers(0, 1 << 20, (S, 1))
    n = np.full(S, C, np.int32)
    n[rng.choice(S, S // 4, replace=False)] = rng.integers(0, C, S // 4)
    n[5], n[6] = 0, 1
    dv16, anchor, ok16, ok8, _ = narrow.build_narrow_delta(
        torch.from_numpy(val.astype(np.float32)), torch.from_numpy(n))
    assert bool((ok8 if kind == "delta8" else ok16).all())
    dv = dv16.numpy().astype(np.int64)
    anchor = anchor.numpy().copy()
    if kind == "delta16" and C >= 258:
        # prefixes to exactly +2^23 and -2^23 (256 x 32767 + 256)
        for r, sign in ((8, 1), (9, -1)):
            dv[r] = 0
            dv[r, 1:257] = sign * 32767
            dv[r, 257] = sign * 256
            assert abs(dv[r].cumsum()).max() == 1 << 23
    anchor[10:14] = (0.5, -3.75, 1234.25, 8388607.5)   # non-integer
    anchor[14], anchor[15] = 16777215.0, -16777215.0   # 2^24 - 1
    dv[14, 1:] = rng.integers(0, 3, C - 1)             # past 2^24: rounds
    dv[15, 1:] = -rng.integers(0, 3, C - 1)
    pool = np.arange(3, S, 8)
    dv[pool] = rng.integers(-hi, hi + 1, (len(pool), C))
    anchor[pool] = np.nan
    anchor[pool[1::2]] = np.inf
    return (torch.from_numpy(dv).to(DTYPES[kind]),
            torch.from_numpy(anchor.astype(np.float32)))


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-equal f32 arrays, NaN where the other is NaN."""
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a[~nan].view(np.uint32) == b[~nan].view(np.uint32)).all())


@pytest.mark.parametrize("C", (8, 130, 768, 1004))
@pytest.mark.parametrize("kind", DELTA_KINDS)
def test_the_decode_model_is_bit_for_bit_the_plain_and_jax_decode(kind, C):
    """C = 130 takes two decode passes a tile, 8 a run wider than the row,
    1004 runs that end short of 16 cells."""
    dv, anchor = edge_rows(kind, C, seed=C)
    rt = fg.k1_launch_shape(dv.shape[0], C, 128, 8, 2)[0]
    got = model_decode(dv, anchor, rt).numpy()
    plain = decodereg.variant(kind).decode(dv, anchor[:, None]).numpy()
    ref = np.asarray(jdr.decode_delta(jnp.asarray(dv.numpy()),
                                      jnp.asarray(anchor.numpy())[:, None]))
    assert got.dtype == plain.dtype == ref.dtype == np.float32
    assert same_bits(got, plain), kind
    assert same_bits(got, ref), kind
    # the edges were reached: pool rows decoded to NaN and Inf, and the
    # anchor add rounded on the rows near 2^23 and 2^24
    assert np.isnan(got[3]).all() and np.isposinf(got[11]).all()
    exact = (anchor.double()[:, None]
             + torch.cumsum(dv.double(), 1)).numpy()[13:16]
    assert (got[13:16] != exact).any()
