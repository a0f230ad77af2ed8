"""The port's six soaks at a tiny size on the CPU.

Each soak runs as ``python -m filodb_tpu_torch.stress.<name> ...
--device cpu``: it exits 0 and its JSON report says every one of its own
checks held. The three deterministic soaks (ingestion, batch, churn) end
in the state the reference soak ``stress/<name>.py`` reaches at the same
size: series created, samples, and the answer of one query (the port's
within the numeric bar of the JAX engine's over the reference soak's own
memstore; bit for bit where the values are integers). The reference soak
runs in process with one change that moves no answer: the ingestion soak's
row capacity, 2^21 in both, is cut to the tiny run's on both sides.
Without a card, and without ``--device cpu``, every soak raises
``DeviceUnavailable`` before it does any work.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from filodb_tpu.core.memstore import StoreConfig as JStoreConfig
from filodb_tpu.core.memstore import TimeSeriesMemStore as JMemStore
from filodb_tpu.query.engine import QueryEngine as JQueryEngine
from filodb_tpu_torch.device import DeviceUnavailable
from filodb_tpu_torch.stress import _common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny sizes, in the order of each soak's positional arguments
TINY = {
    "ingestion_stress": (2000, 40, 10, 2048),
    "batch_ingestion": (50, 120),
    "churn_stress": (12, 200),
    "query_stress": (50, 10, 2),
    "streaming_stress": (2, 200),
    "cluster_stress": (4, 1000),
}


def soak(name):
    return importlib.import_module(f"filodb_tpu_torch.stress.{name}")


@pytest.mark.parametrize("name", sorted(TINY))
def test_soak_runs_on_the_cpu_and_passes_its_checks(name):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", f"filodb_tpu_torch.stress.{name}",
         *map(str, TINY[name]), "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    report = json.loads(lines[0])
    assert report["soak"] == name and report["device"] == "cpu"
    assert report["ok"] and report["checks"] and all(
        report["checks"].values()), report["checks"]
    # the CPU runs the kernels' plain twins: no launch is counted
    assert report.get("k1_raw_launches", 0) == 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_soak_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    mod = soak(name)
    with pytest.raises(DeviceUnavailable):
        mod.main(*TINY[name])
    with pytest.raises(DeviceUnavailable):
        _common.cli(mod.main, mod.__doc__, list(map(str, TINY[name])))


def test_cli_reports_a_failed_check_with_a_nonzero_exit(capsys):
    def main(n=1, device="cuda"):
        return _common.finish({"n": n, "x": float("nan")},
                              {"held": True, "broke": False})
    assert _common.cli(main, "a soak", ["3", "--device", "cpu"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report == {"n": 3, "x": None, "checks": {"held": True,
                                                    "broke": False},
                      "ok": False}


# -- the deterministic soaks against the reference's --------------------------

def _reference(name, capacity=None):
    """The reference soak's module, loaded from ``stress/<name>.py``, with
    every memstore it builds recorded (and its row capacity replaced by
    ``capacity`` when given)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "stress", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = []

    class Recorded(JMemStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    mod.TimeSeriesMemStore = Recorded
    if capacity is not None:
        mod.StoreConfig = lambda **kw: JStoreConfig(
            **{**kw, "max_series_per_shard": capacity})
    return mod, built


def _values(res):
    return np.asarray(res.matrix.values, np.float64)


def _within_bar(got, want, what):
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    top = max(float(np.nanmax(np.abs(want), initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top,
                               err_msg=what)


def test_ingestion_end_state_equals_the_reference():
    from filodb_tpu_torch.stress import ingestion_stress as port
    n_series, n_samples, batch_ts, capacity = TINY["ingestion_stress"]
    got = port.main(n_series, n_samples, batch_ts, capacity, device="cpu")
    assert got["ok"], got["checks"]
    ref, built = _reference("ingestion_stress", capacity=capacity)
    ref.main(n_series, n_samples, batch_ts)
    shard = built[0].shard("stress", 0)
    assert got["series_created"] == shard.num_series == n_series
    assert got["samples_stored"] == shard.store.stats.samples_appended \
        == n_series * n_samples
    assert got["out_of_order_dropped"] \
        == shard.store.stats.out_of_order_dropped == 0
    want = JQueryEngine(built[0], "stress").query_range(
        port.QUERY, *port.query_range(n_samples))
    assert got["exec_path"] == want.exec_path
    _within_bar(got["sum_rate"], _values(want), port.QUERY)


def test_batch_end_state_equals_the_reference():
    from filodb_tpu_torch.stress import batch_ingestion as port
    n_series, n_samples = TINY["batch_ingestion"]
    got = port.main(n_series, n_samples, device="cpu")
    assert got["ok"], got["checks"]
    ref, built = _reference("batch_ingestion")
    assert ref.main(n_series, n_samples) == 0
    ingested, recovered = (ms.shard("batch", 0) for ms in built)
    assert got["series_created"] == ingested.num_series \
        == recovered.num_series == n_series
    assert got["samples"] == got["recovered"] == int(np.asarray(
        recovered.store.n_host[:recovered.num_series]).sum())
    want = JQueryEngine(built[0], "batch").query_range(
        port.QUERY, *port.query_range(n_samples))
    _within_bar(got["sum_rate"], _values(want), port.QUERY)


def test_churn_end_state_equals_the_reference():
    from filodb_tpu_torch.stress import churn_stress as port
    rounds, per_round = TINY["churn_stress"]
    got = port.main(rounds, per_round, device="cpu")
    assert got["ok"], got["checks"]
    ref, built = _reference("churn_stress")
    assert ref.main(rounds, per_round) == 0
    shard = built[0].shard("churn", 0)
    assert (got["series_created"], got["evicted"], got["purged"],
            got["live"], got["samples"]) == (
        shard.stats.series_created, shard.stats.partitions_evicted,
        shard.stats.partitions_purged, shard.num_series,
        shard.stats.rows_ingested)
    assert got["series_created"] == rounds * per_round
    last = port.BASE + (rounds - 1) * port.ROUND_MS
    want = _values(JQueryEngine(built[0], "churn").query_instant(
        port.QUERY, last))
    # integer values: the sums agree bit for bit
    np.testing.assert_array_equal(np.asarray(got["sum"]), want)
