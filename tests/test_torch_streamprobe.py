"""K3, the port's streaming pass, against bench.py's Pallas kernel.

bench.py's ``stream_probe`` runs unchanged, its Pallas kernel in interpret
mode on the CPU; ``jax.jit`` is wrapped so the jitted call's output is
kept (bench.py itself only times it). The port's plain version must give the
same (8, 128) block from the same numpy input: bit for bit on integer data
(every partial an integer below 2^24, exact in any order), within rtol 1e-5
of the largest magnitude on bench.py's exponential-cumsum counters (only
the order of the f32 adds inside a tile differs). The kernel's wrapper
refuses what K3 does not take before any build, and the kernels' launch
counters stay exact under many threads.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from filodb_tpu_torch.ops import kernels
from filodb_tpu_torch.ops import streamprobe as sp


def block(S: int, C: int, data: str) -> np.ndarray:
    rng = np.random.default_rng(S * 7 + C)
    if data == "integer":
        return rng.integers(0, 100, (S, C)).astype(np.float32)
    inc = rng.exponential(5.0, (S, C)).astype(np.float32)
    return np.cumsum(inc, axis=1, dtype=np.float32)


def reference(val: np.ndarray, monkeypatch) -> np.ndarray:
    """bench.py's stream_probe on ``val``: the (8, 128) block its Pallas
    kernel (interpret mode) returned."""
    outs = []
    real_jit = jax.jit

    def keeping_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        kept = {}

        def call(x):
            # the first call computes; bench.py's timing repeats return it
            if "out" not in kept:
                kept["out"] = np.asarray(jitted(x))
                outs.append(kept["out"])
            return kept["out"]
        return call

    monkeypatch.setattr(jax, "jit", keeping_jit)
    bench.stream_probe(jnp.asarray(val))
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(outs) == 1
    return outs[0]


@pytest.mark.parametrize("data", ["integer", "counters"])
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("S", [512, 2148])
def test_plain_matches_the_pallas_kernel(S, C, data, monkeypatch):
    val = block(S, C, data)
    ref = reference(val, monkeypatch)
    got = sp.stream_probe_plain(torch.from_numpy(val)).numpy()
    assert got.shape == ref.shape == (8, 128) and got.dtype == np.float32
    if data == "integer":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
    # the rows past the last whole tile are never read
    rows = S // 512 * 512
    want = val[:rows].astype(np.float64).sum(0)[:128]
    np.testing.assert_allclose(got[0], want, rtol=1e-5)
    assert (got == got[:1]).all()
    # on a CPU tensor the dispatcher takes the plain version
    np.testing.assert_array_equal(
        sp.stream_probe_sum(torch.from_numpy(val)).numpy(), got)


def test_tail_rows_are_not_read():
    val = block(2148, 128, "integer")
    val[2048:] = np.nan
    got = sp.stream_probe_plain(torch.from_numpy(val)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, sp.stream_probe_plain(torch.from_numpy(val[:2048])).numpy())


@pytest.mark.parametrize("val, why", [
    (torch.zeros(512, 128), "CUDA tensor"),
    (torch.zeros(512, 128, dtype=torch.float16), "float32"),
    (torch.zeros(512, 64), "below 128 columns"),
    (torch.zeros(511, 128), "no whole 512-row tile"),
    (torch.zeros(512 * 128), "unit column stride"),
    (torch.zeros(128, 512).T, "unit column stride")],
    ids=["cpu", "float16", "narrow", "short", "one-dim", "column-stride"])
def test_kernel_wrapper_refuses_before_any_build(val, why, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} for an input K3 refuses")
    monkeypatch.setattr(kernels, "load", no_build)
    before = sp.stream_probe_kernel.launches
    with pytest.raises(ValueError, match=f"stream_probe_kernel: .*{why}"):
        sp.stream_probe_kernel(val)
    assert sp.stream_probe_kernel.launches == before


@pytest.mark.parametrize("S", [512, 1024, 4196, 65536, 1 << 20, 3 << 20])
def test_launch_shape_covers_whole_tiles(S):
    per_block, nblocks = sp.k3_launch_shape(S)
    tiles = S // 512
    assert per_block >= 1 and nblocks <= sp.MAP_BLOCKS
    assert (nblocks - 1) * per_block < tiles <= nblocks * per_block


def test_vector_loads_need_aligned_rows():
    assert sp.vector_loads(torch.zeros(512, 768))
    assert not sp.vector_loads(torch.zeros(512, 769)[:, 1:])
    assert not sp.vector_loads(torch.zeros(512, 130))


def test_launch_counts_are_exact_under_threads():
    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.launches_by_kind = {"raw": 0, "delta8": 0}
    threads, per = 64, 1000

    def work(i):
        for _ in range(per):
            kernels.count_launch(wrapper, "raw" if i % 2 else "delta8")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == threads * per
    assert wrapper.launches_by_kind == {"raw": threads // 2 * per,
                                        "delta8": threads // 2 * per}
