"""Time the segment fold's CUDA source against candidate sources on the card.

    python3 -m filodb_tpu_torch.scripts.segfold_variants [name=path.cu ...]

Builds ``ops/csrc/segfold.cu`` (as ``repo``) and each candidate, a source
with the same C interface (``segfold_launch``), with the port's nvcc flags:
one nvcc each, all started together, into a temporary directory. Then, on
chip_smoke.py phase 2e's inputs (non-integer values with NaN cells, one row
in ten outside [0, G)) at the shapes in ``SHAPES``, it holds every source to
the CPU twin bit for bit, a second launch to the first, and prints each
one's time by CUDA events without and with sumsq, beside the longest
chain's nanoseconds an add; exits 1 if any bits differ. The ``third``
rows draw the group ids from {-1, 0, 1} instead, so a third of the rows
are in range: the chain is a third as long. Needs a card: exits 2
without one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from filodb_tpu_torch.bench import cuda_ms
from filodb_tpu_torch.ops import kernels
from filodb_tpu_torch.ops import segfold as sf

# (S, T, G, gids): 8b's S7 and S6 reduces, many groups, 10b's 457 steps,
# few groups and a short chain; "third" as in the module's docstring
SHAPES = ((1 << 20, 1, 1, "third"), (1 << 20, 1, 1, "2e"),
          (1 << 20, 47, 1, "2e"), (1 << 20, 47, 4096, "2e"),
          (1 << 20, 457, 65, "2e"), (1 << 17, 457, 4096, "2e"),
          (1 << 20, 8, 8, "2e"), (4096, 47, 65, "2e"))


def build(sources: dict, out_dir: str) -> dict:
    """name -> (ctypes library, registers of its entry functions)."""
    procs = {}
    for name, src in sources.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise kernels.KernelBuildError(f"{name}: {report}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segfold_launch.restype = i
        lib.segfold_launch.argtypes = [p, i, ctypes.c_longlong, p, p, i,
                                       p, p, p, p]
        regs = sorted({u["registers"] for u in kernels.ptxas_usage(report)})
        libs[name] = (lib, regs)
    return libs


def launch(lib, v, order, offsets, G: int, sumsq: bool) -> dict:
    T = v.shape[1]
    out = {k: torch.empty((G, T), dtype=torch.float64, device=v.device)
           for k in ("sum", "count", "sumsq")}
    err = lib.segfold_launch(
        v.data_ptr(), int(v.dtype == torch.float64), T, order.data_ptr(),
        offsets.data_ptr(), G, out["sum"].data_ptr(),
        out["sumsq"].data_ptr() if sumsq else None, out["count"].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"segfold_launch: CUDA error {err}")
    if not sumsq:
        del out["sumsq"]
    return out


def inputs(S: int, T: int, G: int, dtype, gids_from: str, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn((S, T), generator=g, device="cuda", dtype=torch.float64)
    dec = torch.randint(-3, 6, (S, T), generator=g, device="cuda")
    v = (v * torch.pow(10.0, dec.double())).to(dtype)
    v = torch.where(torch.rand((S, T), generator=g, device="cuda") < 0.2,
                    float("nan"), v).contiguous()
    if gids_from == "third":
        return v, torch.randint(-1, G + 1, (S,), generator=g, device="cuda")
    gids = torch.randint(0, G, (S,), generator=g, device="cuda")
    off = torch.where(torch.rand((S,), generator=g, device="cuda") < 0.5,
                      -1, G + 7)
    return v, torch.where(
        torch.rand((S,), generator=g, device="cuda") < 0.1, off, gids)


def same_bits(a: dict, b: dict) -> bool:
    return all(bool((a[k].cpu().view(torch.int64)
                     == b[k].cpu().view(torch.int64)).all()) for k in b)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("segfold_variants: no CUDA device", file=sys.stderr)
        return 2
    sources = {"repo": os.path.join(kernels.CSRC, "segfold.cu")}
    for arg in argv:
        name, _, path = arg.partition("=")
        sources[name] = path
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        for name, (_lib, regs) in libs.items():
            print(f"{name}: registers {regs}")
        print(card, flush=True)
        for seed, (S, T, G, gids_from) in enumerate(SHAPES):
            for dtype in (torch.float32, torch.float64):
                v, gids = inputs(S, T, G, dtype, gids_from, seed)
                order, offsets = sf.group_rows(gids, G)
                chain = max(int((offsets[1:] - offsets[:-1]).max()), 1)
                want = sf.segment_fold_plain(v.cpu(), gids.cpu(), G, True)
                cells = []
                for name, (lib, _regs) in libs.items():
                    got = launch(lib, v, order, offsets, G, True)
                    ok = same_bits(got, want) and same_bits(
                        launch(lib, v, order, offsets, G, True), got)
                    differ += not ok
                    ms = cuda_ms(lambda: launch(lib, v, order, offsets, G,
                                                False), reps=5)
                    ms_sq = cuda_ms(lambda: launch(lib, v, order, offsets,
                                                   G, True), reps=3)
                    cells.append(f"{name} {ms:.4f} ms ({ms * 1e6 / chain:.2f}"
                                 f" ns an add), sumsq {ms_sq:.4f}, bits "
                                 f"{'ok' if ok else 'DIFFER'}")
                print(f"{S} x {T}, G = {G}, {str(dtype)[6:]}, gids "
                      f"{gids_from}, chain {chain}: " + "; ".join(cells),
                      flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
