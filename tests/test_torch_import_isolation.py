"""The port stands alone: no JAX, no module of the JAX package, no protobuf.

Every module of ``filodb_tpu_torch`` is imported in a fresh interpreter,
which must then hold neither ``jax`` nor ``filodb_tpu`` / ``filodb_tpu.*``
(note the prefix: ``filodb_tpu_torch`` itself starts with ``filodb_tpu``);
no module names ``google.protobuf``.
And the device policy: without a card, building a store or an engine
without ``device=`` raises instead of falling back to the CPU.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import filodb_tpu_torch
from filodb_tpu_torch.core.chunkstore import SeriesStore
from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
from filodb_tpu_torch.core.schemas import GAUGE
from filodb_tpu_torch.device import DeviceUnavailable
from filodb_tpu_torch.query.engine import QueryEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    """Every Python module of the package (built shared libraries such as
    the native part-set table are not modules)."""
    return sorted(m.name for m in pkgutil.walk_packages(
        filodb_tpu_torch.__path__, "filodb_tpu_torch.")
        if m.module_finder.find_spec(m.name).origin.endswith(".py"))


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = port_modules()
    for m in ("ops.fusedgrid", "ops.fusedresident", "ops.narrow",
              "ops.decodereg", "ops.gridfns", "ops.rangefns", "ops.kernels",
              "ops.windows", "ops.instantfns", "ops.binop",
              "ops.aggregators", "core.chunkstore", "core.memstore",
              "core.schemas", "query.exec", "query.engine", "query.planner",
              "query.logical", "query.rangevector", "parallel.distributed",
              "parallel.shardmapper", "utils.metrics", "utils.tracing",
              "core.cardinality", "query.incremental", "query.scheduler",
              "parallel.cluster", "memory.nibblepack", "memory.deltadelta",
              "memory.intpack", "memory.hist", "memory.native", "core.store",
              "ingest.bus", "core.downsample", "jobs.batch_downsampler",
              "query.retention", "utils.netio", "query.wire", "http.api",
              "core.diststore", "parallel.bootstrap", "entry", "config",
              "standalone", "cli", "ingest.broker", "ingest.replication",
              "ingest.gateway", "ingest.stream", "ingest.faults", "cluster",
              "cluster.epoch", "cluster.gossip", "cluster.membership",
              "rules", "rules.spec", "utils.profiler", "utils.snappy",
              "promql.remote", "promql.remote_storage", "rules.state",
              "rules.publish", "rules.evaluator", "rules.alerts",
              "rules.scheduler", "rules.manager", "core.computed",
              "scripts", "scripts.downsample_validator",
              "scripts.bench_suite", "stress",
              "stress._common", "stress.ingestion_stress",
              "stress.batch_ingestion", "stress.churn_stress",
              "stress.query_stress", "stress.streaming_stress",
              "stress.cluster_stress"):
        assert f"filodb_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before"
        " if m == 'jax' or m.startswith('jax.')"
        " or m == 'filodb_tpu' or m.startswith('filodb_tpu.'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_file_names_jax_or_the_jax_package():
    """Static twin of the subprocess check (it also holds on an interpreter
    that imported JAX before the port did)."""
    pkg = os.path.dirname(filodb_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib", "filodb_tpu"), (f, name)


def test_no_module_imports_protobuf():
    """The remote-storage messages go through the port's own codec
    (``promql/remote_storage.py``): no module of the port imports
    ``google.protobuf``, which the card's machine does not have."""
    pkg = os.path.dirname(filodb_tpu_torch.__file__)
    seen = 0
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            seen += 1
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module] + [f"{node.module}.{a.name}"
                                             for a in node.names]
                else:
                    continue
                for name in names:
                    assert not (name == "google" or name.startswith(
                        "google.protobuf")), (f, name)
    assert seen > 80


def test_no_card_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(DeviceUnavailable):
        SeriesStore(8, 16)
    with pytest.raises(DeviceUnavailable):
        TimeSeriesMemStore()
    ms = TimeSeriesMemStore(device="cpu")
    with pytest.raises(DeviceUnavailable):
        ms.setup("p", GAUGE, 0, StoreConfig(max_series_per_shard=8,
                                            samples_per_series=16,
                                            device="cuda"))
    with pytest.raises(DeviceUnavailable):
        QueryEngine(ms, "p")
    # asking for the CPU works
    ms.setup("p", GAUGE, 0, StoreConfig(max_series_per_shard=8,
                                        samples_per_series=16))
    assert QueryEngine(ms, "p", device="cpu").device.type == "cpu"


def test_full_f32_matmuls_are_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_a_mesh_of_cards_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh resolves to it")
    from filodb_tpu_torch.parallel.distributed import make_mesh
    with pytest.raises(DeviceUnavailable):
        make_mesh()
    ms = TimeSeriesMemStore(device="cpu")
    ms.setup("p", GAUGE, 0, StoreConfig(max_series_per_shard=8,
                                        samples_per_series=16))
    with pytest.raises(DeviceUnavailable):
        QueryEngine(ms, "p", device="cpu", mesh=["cuda"])
    assert QueryEngine(ms, "p", device="cpu",
                       mesh=["cpu"] * 2).mesh == [torch.device("cpu")] * 2
