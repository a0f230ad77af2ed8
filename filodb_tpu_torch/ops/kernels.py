"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``filodb_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed on the source's content and the flags, so
an edited source rebuilds and an unchanged one loads. ``build()`` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs when a module is imported: the CPU tests import every
module on a host that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

KERNELS = ("fusedgrid",)

_lock = threading.Lock()
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
    """The built library of ``csrc/<name>.cu`` for the current source."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read())
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib
