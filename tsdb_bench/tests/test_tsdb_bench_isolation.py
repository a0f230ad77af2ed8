"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole: ``filodb_tpu_torch`` is not ``filodb_tpu``), and for the
plain reference nothing of the program either."""

import json
import subprocess
import sys

import pytest

from tsdb_bench import harness

CHECK = """
import json, sys
{body}
tops = sorted({{m.split('.', 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", CHECK.format(body=body)],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import tsdb_bench.reference.plain, "
                  "tsdb_bench.data.counters, tsdb_bench.data.histograms, "
                  "tsdb_bench.roofline.k1, tsdb_bench.roofline.k2")
    assert not tops & {"jax", "jaxlib", "flax", "filodb_tpu",
                       "filodb_tpu_torch"}, tops


@pytest.mark.parametrize("cell", ["prom_counters_1m.sum_rate_dash",
                                  "prom_hist_131k.hist_mix"])
def test_a_run_loads_no_jax(cell):
    body = f"""
from tsdb_bench import harness
from tsdb_bench.tests.small import SMALL
bench = harness.load_bench()
c = harness.by_name(bench['workloads'], {cell!r}, 'workload')
out = harness.run_cell(bench, {cell!r}, 5, 0.5, True, 'cpu',
                       cfg_override=SMALL[c['config']], log=lambda *a: None)
assert harness.forbidden_modules() == [], harness.forbidden_modules()
"""
    tops = loaded(body)
    assert "filodb_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "filodb_tpu"}, tops


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "filodb_tpu_torch_x", object())
    assert "filodb_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "tsdb_bench.run",
                          "--workload", "prom_counters_1m.sum_rate_dash",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=600)
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "tsdb_bench.run",
                          "--workload", "prom_counters_1m.sum_rate_dash",
                          "--seed", "3", "--seconds", "2", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
