"""K1's launch shape over every shape the fused gate admits.

``ops/fusedgrid.py::k1_launch_shape`` picks the rows a block stages per tile
and the row chunks of the grid; ``k1_smem_bytes`` mirrors the shared-memory
sum of ``csrc/fusedgrid.cu::smem_bytes``. Checked here, as arithmetic (the
kernel itself runs only on the card, in chip_smoke.py): a block's shared
memory stays within what an H100 block may opt into, the chunks cover the
rows exactly with none empty, and the scratch partials stay within 64 MB.
"""

import os
import re

import pytest

from filodb_tpu_torch.ops import fusedgrid as fg

H100_SMEM_OPT_IN = 232_448      # bytes a block may opt into (227 KB)
SCRATCH_LIMIT = 64 << 20
KINDS = tuple(fg.KIND_CODES)
# G after the aggregate pads it to a multiple of 8; Tp a multiple of 128
GROUPS = tuple(range(8, fg.MAX_GROUPS + 1, 8))
STEPS = tuple(range(fg.K1_STEPS, fg.MAX_STEPS + 1, fg.K1_STEPS))
# fusable row counts: multiples of 512, or multiples of 8 up to 512
ROWS = (8, 16, 120, 504, 512, 1024, 4096, 66048, 1 << 20, (1 << 20) + 512,
        3 << 20)
COLUMNS = tuple(range(1, fg.MAX_CAPACITY + 1))

CU = os.path.join(os.path.dirname(fg.__file__), "csrc", "fusedgrid.cu")


@pytest.mark.parametrize("nout", (2, 3))
@pytest.mark.parametrize("G", GROUPS)
def test_shared_memory_fits_an_h100_block(G, nout):
    for Ca in COLUMNS:
        rt = fg.k1_launch_shape(4096, Ca, fg.K1_STEPS, G, nout)[0]
        assert 1 <= rt <= 32, (Ca, rt)
        for kind in KINDS:
            smem = fg.k1_smem_bytes(Ca, rt, G, nout, kind)
            assert smem <= H100_SMEM_OPT_IN, (Ca, G, nout, kind, smem)


@pytest.mark.parametrize("nout", (2, 3))
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("Tp", STEPS)
def test_chunks_cover_the_rows_and_scratch_fits(Tp, G, nout):
    for S in ROWS:
        assert fg.fusable(S, 128, Tp, G)
        for Ca in COLUMNS:
            rt, rows_per_block, nchunks = fg.k1_launch_shape(S, Ca, Tp, G,
                                                             nout)
            assert rt >= 1 and rows_per_block >= 1 and nchunks >= 1
            # every row in exactly one chunk, and no chunk empty
            assert nchunks * rows_per_block >= S, (S, Ca, rows_per_block)
            assert (nchunks - 1) * rows_per_block < S, (S, Ca, nchunks)
            assert nchunks * nout * G * Tp * 4 <= SCRATCH_LIMIT, (S, Ca)


def test_the_bench_shape_keeps_its_chunks():
    """2^20 rows x 768 columns, 47 steps, G = 8: 1024 chunks of 1024 rows,
    as before the tile changed, so the block-order fold and every partial
    stay bit for bit the same at bench.py's shape."""
    rt, rows_per_block, nchunks = fg.k1_launch_shape(1 << 20, 768, 128, 8, 2)
    assert (rows_per_block, nchunks) == (1024, 1024)
    assert rt == 5
    # two raw tile buffers leave room for four such blocks on an SM
    assert 4 * (fg.k1_smem_bytes(768, rt, 8, 2) + 1024) <= 233_472


@pytest.mark.parametrize("name,value", (("kSteps", fg.K1_STEPS),
                                        ("kTerms", fg.K1_TERMS)))
def test_the_cuda_source_has_the_same_constants(name, value):
    with open(CU) as f:
        src = f.read()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value, name
