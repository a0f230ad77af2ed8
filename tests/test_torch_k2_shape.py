"""K2's launch shape and prefix segments over every shape the hist gate admits.

``ops/fusedresident.py::k2_launch_shape`` picks the rows a block stages per
pass, the row chunks (one block each, every active step in that block), the
step tile of the time terms and where the accumulator lives;
``k2_smem_bytes`` mirrors the shared-memory sum of
``csrc/fusedhist.cu::layout``; ``k2_segments`` cuts the needed cells into
the segments the kernel sums. Checked here, as arithmetic (the kernel itself
runs only on the card, in chip_smoke.py): a block's shared memory stays
within what an H100 block may opt into, the chunks cover the rows exactly
with none empty, the scratch partials stay within 64 MB, phase 7's shape
keeps its chunks, and the segments rebuild the band products exactly.
"""

import os
import re

import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import fusedgrid as fg
from filodb_tpu_torch.ops import fusedresident as fr

H100_SMEM_OPT_IN = 232_448      # bytes a block may opt into (227 KB)
SCRATCH_LIMIT = 64 << 20
GROUPS = tuple(range(8, fg.MAX_GROUPS + 1, 8))
COLUMNS = tuple(range(1, fg.MAX_CAPACITY + 1))
# B with at least one padded step count: Tp is a multiple of 128 and
# Tp * B <= 4096
BUCKETS = tuple(b for b in range(1, fr.MAX_BUCKETS + 1)
                if 128 * b <= fg.MAX_STEPS * 8)
# fusable row counts: multiples of 512, or multiples of 8 up to 512
ROWS = (8, 16, 120, 504, 512, 1024, 4096, 66048, 1 << 17, 1 << 20,
        (1 << 20) + 512, 3 << 20)

CU = os.path.join(os.path.dirname(fr.__file__), "csrc", "fusedhist.cu")


def step_counts(B):
    return tuple(range(128, fg.MAX_STEPS * 8 // B + 1, 128))


def worst_tables(C, nsteps):
    """(cmax, K, J) at their largest for C columns and ``nsteps`` active
    steps: every step adds at most three cells, and segments of at most
    K2_SEG_CELLS cells split the gaps."""
    K = min(C, 1 + 3 * nsteps)
    return C - 1, K, K + (C - K) // fr.K2_SEG_CELLS


def check_fits(S, B, elt, G, C, nsteps, K=None):
    cmax, Kmax, J = worst_tables(C, nsteps)
    K = Kmax if K is None else K
    J = max(J, K)
    shape = fr.k2_launch_shape(S, B, elt, G, cmax, K, J, nsteps)
    assert shape.smem == fr.k2_smem_bytes(
        B, elt, cmax, G, nsteps, K, J, shape.rows_pass, shape.tile_steps,
        shape.acc_shared)
    assert shape.smem <= H100_SMEM_OPT_IN, (B, elt, G, C, nsteps, shape)
    assert shape.tile_steps * B <= fr.K2_THREADS * fr.K2_COLS
    assert 1 <= shape.tile_steps <= max(nsteps, 1)
    if shape.acc_shared:
        assert shape.smem <= fr.K2_PAIR_BYTES
    return shape


@pytest.mark.parametrize("elt", (1, 2))
@pytest.mark.parametrize("B", BUCKETS)
def test_shared_memory_fits_an_h100_block(B, elt):
    """Every C at the fewest and the most steps, the most needed cells and
    segments; every padded step count at a few C; every G."""
    for G in GROUPS:
        for Tp in {step_counts(B)[0], step_counts(B)[-1]}:
            for C in COLUMNS:
                for nsteps in (1, Tp):
                    check_fits(4096, B, elt, G, C, nsteps)
        for Tp in step_counts(B):
            for C in (1, 127, 320, 1023, 1024):
                check_fits(4096, B, elt, G, C, Tp)
                check_fits(4096, B, elt, G, C, Tp, K=1)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("B", (1, 7, 11, 32))
def test_chunks_cover_the_rows_and_scratch_fits(B, G):
    for S in ROWS:
        for C in (1, 129, 320, 1024):
            for nsteps in (0, 1, 39, step_counts(B)[-1]):
                shape = check_fits(S, B, 1, G, C, nsteps)
                assert shape.rows_pass >= 1 and shape.nchunks >= 1
                # every row in exactly one chunk, and no chunk empty
                rpb = shape.rows_per_block
                assert shape.nchunks * rpb >= S, (S, C, shape)
                assert (shape.nchunks - 1) * rpb < S, (S, C, shape)
                assert shape.nchunks <= fr.K2_CHUNKS
                scratch = shape.nchunks * 2 * G * max(nsteps * B, 1) * 4
                assert scratch <= SCRATCH_LIMIT, (S, C, nsteps, shape)


def phase7_operands():
    """K2's operands at chip_smoke.py phase 7's query: 2^17 x 320 x 32 i8,
    rate over 5m, 39 steps of 60 s from 10 minutes into the data, padded to
    64 by repeating the last step (as the engine evaluates it)."""
    C, iv = 320, 10_000
    out_ts = np.arange(600_000, 290 * iv + 1, 60_000, dtype=np.int64)
    out_ts = np.concatenate([out_ts, np.full(64 - len(out_ts), out_ts[-1])])
    return fr.hist_device_operands(C, 128, out_ts.tobytes(), 300_000, 0, iv,
                                   torch.device("cpu"))


def test_the_phase7_shape_keeps_its_chunks():
    """256 chunks of 512 rows, as before the redesign, so the chunk-order
    fold and every partial stay bit for bit the parent's at phase 7; one
    block per chunk walks the 39 distinct steps of the 64 active ones (no
    step tile re-stages rows), 4 rows (37 KB of dd) a pass, two blocks an
    SM (the accumulator in scratch, its current group in registers)."""
    ops = phase7_operands()
    active = int((ops.hi >= 0).sum())
    assert (ops.kseg.numel(), ops.cmax, active) == (45, 288, 64)
    assert ops.nsteps == 39 and ops.nsegs == 48
    shape = fr.k2_launch_shape(1 << 17, 32, 1, 8, ops.cmax, ops.kseg.numel(),
                               ops.nsegs, ops.nsteps)
    assert (shape.rows_per_block, shape.nchunks) == (512, 256)
    assert shape.rows_pass == 4 and shape.tile_steps == ops.nsteps
    assert not shape.acc_shared
    assert shape.rows_pass * 289 * 32 >= fr.K2_STAGE_BYTES
    assert 2 * (shape.smem + 1024) <= 233_472


def test_distinct_steps_map_every_active_step():
    """k2_step_table: each active step (hi >= 0) maps to the first step with
    its (lo, hi, rel); inactive steps to -1; the distinct steps in order."""
    ops = phase7_operands()
    lo, hi, rel = (t.numpy()[0] for t in (ops.lo, ops.hi, ops.rel))
    usteps, ucol = ops.usteps.numpy(), ops.ucol.numpy()
    assert (np.diff(usteps) > 0).all()
    for t in range(len(lo)):
        if hi[t] < 0:
            assert ucol[t] == -1
            continue
        u = usteps[ucol[t]]
        assert (lo[u], hi[u], rel[u]) == (lo[t], hi[t], rel[t]) and u <= t
    keys = {(lo[u], hi[u], rel[u]) for u in usteps}
    assert len(keys) == len(usteps)
    np.testing.assert_array_equal(usteps, np.arange(39))


@pytest.mark.parametrize("name,value", (("kThreads", fr.K2_THREADS),
                                        ("kCols", fr.K2_COLS)))
def test_the_cuda_source_has_the_same_constants(name, value):
    with open(CU) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value, name


def test_the_segments_cover_the_cells():
    rng = np.random.default_rng(3)
    for _ in range(200):
        C = int(rng.integers(1, 1025))
        cells = np.unique(np.concatenate(
            [[0], rng.integers(0, C, int(rng.integers(0, 40)))]))
        bounds, kseg = fr.k2_segments(cells)
        assert bounds[0] == 0 and bounds[-1] == cells[-1] + 1
        lens = np.diff(bounds)
        assert (lens >= 1).all() and (lens <= fr.K2_SEG_CELLS).all()
        np.testing.assert_array_equal(bounds[kseg + 1], cells + 1)
        _cmax, _k, jmax = worst_tables(C, len(cells))
        assert len(bounds) - 1 <= max(jmax, len(cells))


def test_the_segments_reproduce_the_band_products():
    """The kernel's prefix scheme in numpy: u32 sums over each segment,
    a wrapping scan over the segments, a scan over the buckets at each
    needed cell, read at the slots' segments — equal to cumsum_b(dd @
    band_open) and cumsum_b(dd @ prefix_lo) exactly, for every kind of
    step (before the data, empty windows, hi past the last cell, padding)."""
    rng = np.random.default_rng(72)
    for C, B in ((64, 8), (127, 11), (300, 4)):
        dd = rng.integers(-128, 128, (8, C, B)).astype(np.int64)
        for iv, window, start in ((10_000, 300_000, -50_000),
                                  (10_000, 5_000, 3_000), (7, 35, 0),
                                  (10_000, 95_000, 400 * 10_000)):
            out_ts = np.arange(start, start + 90 * 13 * iv // 10 + 1,
                               13 * iv // 10, dtype=np.int64)[:90]
            Tp = -(-len(out_ts) // 128) * 128
            band, plo, lo, hi, _rel = fr.hist_operands(C, Tp, out_ts, window,
                                                       0, iv)
            cells, slots, t0, t1 = fr.k2_cell_tables(C, lo, hi)
            bounds, kseg = fr.k2_segments(cells)
            seg = np.stack([dd[:, a:b].sum(axis=1) for a, b in
                            zip(bounds[:-1], bounds[1:])], axis=1)
            P = np.cumsum(seg, axis=1).astype(np.uint32)     # wraps as u32
            Q = np.cumsum(P[:, kseg], axis=2, dtype=np.uint32)
            flat = torch.from_numpy(dd.astype(np.float32)).permute(0, 2, 1)
            want_d = torch.cumsum(flat @ torch.from_numpy(band), dim=1)
            want_f = torch.cumsum(flat @ torch.from_numpy(plo), dim=1)
            for t in range(Tp):
                got_d = np.zeros((8, B))
                got_f = np.zeros((8, B))
                if hi[0, t] >= 0:
                    assert t0 <= t < t1
                    if hi[0, t] > lo[0, t]:
                        got_d = (Q[:, slots[0, t]] - (
                            Q[:, slots[1, t]] if slots[1, t] >= 0
                            else np.uint32(0))).astype(np.int32)
                    if slots[2, t] >= 0:
                        got_f = (Q[:, slots[2, t]] - Q[:, 0]).astype(np.int32)
                np.testing.assert_array_equal(got_d, want_d[:, :, t].numpy())
                np.testing.assert_array_equal(got_f, want_f[:, :, t].numpy())


def test_packed_i8_segment_sums_equal_the_bucket_sums():
    """K2's i8 segment sums add four buckets a word: each byte moved by 128
    into [0, 255], even and odd bytes added in 16-bit lanes, 128 a cell
    taken off at the end. For every segment length up to K2_SEG_CELLS, at
    the extreme bytes too, that equals each bucket's sum mod 2^32."""
    rng = np.random.default_rng(5)
    for n in range(1, fr.K2_SEG_CELLS + 1):
        for cells in (rng.integers(-128, 128, (500, n, 4)),
                      np.full((1, n, 4), -128), np.full((1, n, 4), 127)):
            b = cells.astype(np.int8).view(np.uint8).astype(np.uint32)
            words = (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16
                     | b[..., 3] << 24)
            x = words ^ np.uint32(0x80808080)
            even = (x & np.uint32(0x00FF00FF)).sum(axis=1, dtype=np.uint32)
            odd = ((x >> 8) & np.uint32(0x00FF00FF)).sum(axis=1,
                                                          dtype=np.uint32)
            bias = np.uint32(128 * n)
            got = np.stack([(even & 0xFFFF) - bias, (odd & 0xFFFF) - bias,
                            (even >> 16) - bias, (odd >> 16) - bias], axis=1)
            want = cells.sum(axis=1).astype(np.int64).astype(np.uint32)
            np.testing.assert_array_equal(got.astype(np.uint32), want)
