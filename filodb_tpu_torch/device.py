"""Device policy of the port: explicit devices, no silent fallback.

Every store and engine takes a ``device``. The default is ``"cuda"``: a
caller that wants the CPU says so (the CPU tests always pass
``device="cpu"``). When the card is absent and the caller did not ask for the
CPU, construction raises instead of carrying on somewhere else — a server
that quietly answers from the CPU would hide a broken deployment behind
latency.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` as given, or
    ``cuda`` when None. Raises :class:`DeviceUnavailable` for a CUDA device
    on a host without one."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA is not available on this host; pass device=\"cpu\" to "
                "run the port on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def configure_numerics() -> None:
    """Full-f32 products everywhere. The band and one-hot operands of the
    window kernels are 0/1 masks multiplied against f32 sample values; TF32
    keeps only ~10 mantissa bits (about three decimal digits) of each
    value, which would turn exact window sums into approximate ones. cuDNN
    defaults to TF32 for f32 convolutions, so both switches are set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
