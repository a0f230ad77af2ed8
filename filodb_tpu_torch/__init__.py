"""filodb_tpu_torch — the PyTorch/CUDA port of filodb_tpu for NVIDIA Hopper.

The package mirrors ``filodb_tpu``'s layout module for module (core/, ops/,
query/, promql/, utils/) and answers the same PromQL over the same ingest
path. Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU is a kernel written by hand for the H100 (``ops/csrc``).

Device policy (device.py): entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit CPU request they raise.
Timestamps are int64 tensors end to end; values are f32 (f64 for parity
stores, following ``StoreConfig.dtype``).

This slice ports the main path: ingest -> flush -> ``sum(rate(m[5m]))``
through the fused-grid kernel. Other routes raise ``QueryError(... not yet
ported)``.
"""

__version__ = "0.1.0"

from . import device as _device  # noqa: E402

_device.configure_numerics()
