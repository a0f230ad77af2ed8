"""filolint for the port: project-invariant static analysis of the port.

The reference's analyzer (``filodb_tpu/analysis``) re-pointed at this
package: the same engine (a per-module call graph plus per-function CFGs,
analysis/callgraph.py and analysis/cfg.py, over one shared parsed corpus)
and the same rule families, judging the port against its own declared
surfaces:

  * **lock discipline** (lockcheck) — ``*_locked`` methods run under the
    owning object's lock (core/memstore.py's shard ``TimedRLock``), state
    mutated by them is not written from non-holders, and the three lock
    classes keep utils/diagnostics.py's ``LOCK_ORDER``.
  * **wire exhaustiveness** (wirecheck) — query/wire.py's tagged-binary
    codec, the broker / replication / store-ring / cluster ``OP_`` tables
    and the trace-context carriers are two-sided, and every typed query
    error is classified by http/api.py.
  * **resource lifecycle**, **except-flow** (resourcecheck, exceptcheck).
  * **declared surface** (surfacecheck) — config keys in config.py's
    ``CONFIG_SPEC``, metric names in utils/metrics.py's ``METRICS_SPEC``,
    span names in utils/tracing.py's ``TRACE_SPEC``, bounded caches.
  * **epoch & visibility** (epochcheck) against core/memstore.py's
    ``EPOCH_SPEC``; **liveness** (livecheck) against utils/diagnostics.py's
    ``LATENCY_SPEC``, whose ``"blocking"`` taxonomy carries the port's
    ``device-sync`` kind (``.cpu()``, ``.item()``, ``synchronize``): a host
    copy or a stream wait under the shard lock is a declared site or a
    finding.
  * **columnar index** (indexcheck) over core/index*.py.
  * **decode registry** (decodecheck) in the port's terms: every
    ``register_variant`` in ops/decodereg.py passes a plain ``decode=``
    twin, and the registered names are exactly the keys of
    ops/fusedgrid.py's ``KIND_CODES`` (the kernel's variant codes).

The reference's ``jitcheck`` and ``meshcheck`` judge ``jax.jit``/``pjit``
programs, which the port does not have; they have no port.

Everything is pure ``ast`` — no torch import, no device. Findings are
suppressible inline with a ``filolint: ignore[<rule>]`` comment and its
reason on the flagged line, or via the baseline file
(``filodb_tpu_torch/analysis/baseline.json``, empty).

Run it:

    python -m filodb_tpu_torch.analysis          # exit 1 on new findings
    pytest tests/test_torch_static_analysis.py   # fixtures + the tree
"""

from .findings import Baseline, Finding, load_suppressions
from .runner import ALL_RULES, AnalysisReport, analyze_file, run_analysis

__all__ = [
    "ALL_RULES",
    "AnalysisReport",
    "Baseline",
    "Finding",
    "analyze_file",
    "load_suppressions",
    "run_analysis",
]
