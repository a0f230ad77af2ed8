"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``filodb_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed on the content of the source, of the
shared headers (``csrc/*.cuh``) and of the flags, so an edited source
rebuilds and an unchanged one loads. ``build()`` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs when a module is imported: the CPU tests import every
module on a host that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.normpath(
    os.path.join(os.path.dirname(CSRC), os.pardir, "_build"))

# --fmad=false and no --use_fast_math: the kernels repeat the reference's f32
# expressions one rounding at a time (no contraction, IEEE division)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

KERNELS = ("fusedgrid", "fusedhist", "streamprobe")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}       # name -> nvcc's report (-Xptxas -v)


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels build from ops/csrc at first use")


def lib_path(name: str) -> str:
    """The built library of ``csrc/<name>.cu`` for the current sources."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> list[str]:
    """Compile every stale library in ``names`` in parallel (one nvcc per
    source). Returns the names actually compiled."""
    pending = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in pending:
        report, _ = proc.communicate()
        build_log[name] = report
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)      # atomic: a loader never sees half a file
    if failed:
        raise KernelBuildError("\n".join(failed))
    return [p[0] for p in pending]


def _entry_name(sym: str) -> str:
    """A kernel's name from its mangled symbol: the last name of its
    nested-name chain and its integer template arguments
    (``_ZN12_GLOBAL__N_119fused_grid_map_ringILi1EEEvNS_6ParamsE`` ->
    ``fused_grid_map_ring<1>``); anything else comes back as it is."""
    m = re.match(r"_ZN?", sym)
    if m is None:
        return sym
    i, name = m.end(), sym
    while (d := re.match(r"\d+", sym[i:])) is not None:
        n = int(d.group(0))
        name = sym[i + len(d.group(0)):i + len(d.group(0)) + n]
        i += len(d.group(0)) + n
    args = re.match(r"I((?:Li-?\d+E)+)E", sym[i:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def ptxas_usage(report: str) -> list[dict]:
    """Each entry function's registers and spills from nvcc's ``-Xptxas -v``
    report, in the report's order: dicts of ``kernel`` (its name, see
    :func:`_entry_name`), ``registers``, ``spill_stores`` and
    ``spill_loads`` (bytes)."""
    out, entry, spills = [], None, (0, 0)
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            out.append({"kernel": _entry_name(entry),
                        "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1]})
            entry = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib


def count_launch(wrapper, kind: str | None = None) -> None:
    """One more launch on ``wrapper.launches`` (and, given ``kind``, on
    ``wrapper.launches_by_kind[kind]``). Wrappers run on many query threads
    at once, and ``+= 1`` on an attribute can lose an update between two of
    them, so every count goes through one lock. The counts stay plain ints
    that a caller reads (and sets to 0 between runs)."""
    with _count_lock:
        wrapper.launches += 1
        if kind is not None:
            wrapper.launches_by_kind[kind] += 1
