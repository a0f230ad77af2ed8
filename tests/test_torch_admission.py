"""Cost-based admission and the query scheduler, in both packages.

The controller and the scheduler are host Python copied from the
reference: each sequence runs on both classes and must give the same
outcomes, errors and stats. The engine's ``estimate_cost`` must equal the
reference's on the same queries over the same seeded rows, on a raw store
and on a compressed-resident one (delta8 counters: the narrow discount).
A shed raises ``AdmissionRejected`` and lands in ``QueryStats`` and the
slow-query ring; a cost no budget can ever admit raises a plain
``QueryError``. Costs compare exactly (the same float arithmetic on the
same counts).
"""

import threading
import time

import numpy as np
import pytest

from filodb_tpu.promql import parser as jpromql
from filodb_tpu.query import engine as jengine
from filodb_tpu.query import scheduler as jsched
from filodb_tpu.query.rangevector import QueryError as JQueryError
from filodb_tpu_torch.promql import parser as tpromql
from filodb_tpu_torch.query import engine as tengine
from filodb_tpu_torch.query import scheduler as tsched
from filodb_tpu_torch.query.rangevector import QueryError
from tests.test_torch_result_cache import (CELLS, START, Pair, counters,
                                           fresh_dataset, jax_xla_mode,
                                           slow_entries, slow_logs_cleared)

__all__ = ["jax_xla_mode"]      # the autouse fixture, re-exported

RANGE = (START + 300_000, START + 500_000, 30_000)
COST_QUERIES = (
    "sum(rate(m[2m]))", 'sum(rate(m{host="h1"}[2m]))', "rate(m[4m])",
    "sum(rate(m[2m])) + sum(rate(m[2m]))", "m", "scalar(sum(m)) * m",
    "max_over_time(sum(rate(m[2m]))[5m:1m])", "sort(m)", "vector(1)",
    f"sum(m @ {START // 1000 + 400})", "histogram_quantile(0.9, m)",
    'label_replace(m, "x", "$1", "host", "(.*)")', "sum(nope)")


def make_pair(residency: str = "off", n_series: int = 8) -> Pair:
    p = Pair(fresh_dataset("adm"), max_series=32, residency=residency)
    for i in range(n_series):
        p.ingest(i, 0, CELLS)
    p.flush()
    return p


def _outcome(fn):
    """What a call did: its value, or its exception's type name and
    message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return (type(e).__name__, str(e))


def _controller_sequence(mod):
    ctl = mod.AdmissionController(100.0, {"t1": 30.0}, retry_after_s=2.0,
                                  tags={"dataset": fresh_dataset("ctl")})
    out = [_outcome(lambda: ctl.acquire(60.0)),
           _outcome(lambda: ctl.acquire(50.0)),            # 110 > 100: shed
           _outcome(lambda: ctl.acquire(20.0, tenant="t1")),
           _outcome(lambda: ctl.acquire(20.0, tenant="t1")),  # quota 30
           _outcome(lambda: ctl.acquire(15.0, tenant="t2")),
           _outcome(lambda: ctl.acquire(150.0)),           # never admissible
           _outcome(lambda: ctl.acquire(50.0, tenant="t1")),  # over quota
           _outcome(lambda: ctl.acquire(0.1)),             # floored to 1
           ctl.stats()]
    ctl.release(60.0)
    ctl.release(20.0, tenant="t1")
    ctl.release(15.0, tenant="t2")
    ctl.release(1.0)
    out.append(ctl.stats())
    with ctl.admitted(40.0, tenant="t3") as got:
        out.append((got, ctl.stats()))
    out.append(ctl.stats())
    quota_only = mod.AdmissionController(None, {"small": 1.0})
    out += [_outcome(lambda: quota_only.acquire(5.0, tenant="small")),
            _outcome(lambda: quota_only.acquire(1e12, tenant="big")),
            quota_only.stats()]
    return out, ctl.tags


def test_admission_controller_matches_the_reference():
    got, ttags = _controller_sequence(tsched)
    ref, jtags = _controller_sequence(jsched)
    assert got == ref
    assert got[1][0] == "AdmissionRejected"
    assert got[5][0] == "QueryError" and "never be admitted" in got[5][1]
    for tenant, n in (("none", 1), ("t1", 1)):
        assert tsched.registry.counter(
            tsched.FILODB_QUERY_ADMISSION_SHED,
            dict(ttags, tenant=tenant)).value == n
    assert tsched.registry.counter(
        tsched.FILODB_QUERY_ADMISSION_OVERSIZED,
        dict(ttags, tenant="none")).value == 1


def test_admission_rejected_is_a_query_error():
    e = tsched.AdmissionRejected("shed", retry_after_s=3.0, cost=5.0,
                                 tenant="a")
    assert isinstance(e, QueryError)
    assert (e.retry_after_s, e.cost, e.tenant) == (3.0, 5.0, "a")
    assert issubclass(jsched.AdmissionRejected, JQueryError)


def test_admission_never_exceeds_the_budget_under_concurrency():
    """Whatever the interleaving, the reserved cost never passes the
    budget, and every client that retries lands."""
    ctl = tsched.AdmissionController(100.0)
    peak = [0.0]
    lock = threading.Lock()
    landed = []

    def worker():
        for _ in range(50):
            while True:
                try:
                    with ctl.admitted(30.0):
                        with lock:
                            peak[0] = max(peak[0], ctl.stats()["in_use"])
                    break
                except tsched.AdmissionRejected:
                    continue
        with lock:
            landed.append(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(landed) == 8 and peak[0] <= 100.0
    assert ctl.stats()["in_use"] == 0.0


def _scheduler_sequence(mod):
    """Priority order, the bounded queue, errors to the caller, stats."""
    out = []
    sched = mod.QueryScheduler(num_threads=1, max_queue=8,
                               name=fresh_dataset("sched"))
    order = []
    release = threading.Event()
    try:
        blocker = sched.submit(lambda: release.wait(5))
        time.sleep(0.05)
        futs = [sched.submit(lambda i=i: order.append(("q", i)))
                for i in range(4)]
        futs.append(sched.submit(lambda: order.append(("admin",)),
                                 mod.Priority.ADMIN))
        futs.append(sched.submit(lambda: order.append(("meta",)),
                                 mod.Priority.METADATA))
        out.append(_outcome(lambda: [sched.submit(lambda: None)
                                     for _ in range(4)]) [0])
        out.append(_outcome(lambda: sched.submit(lambda: "x",
                                                 mod.Priority.ADMIN)
                            .__class__.__name__))
        release.set()
        for f in [blocker, *futs]:
            f.result(timeout=5)
        out.append(list(order))
        out.append(_outcome(lambda: sched.run(lambda: 1 // 0, timeout_s=5)))
        out.append(_outcome(lambda: sched.run(lambda: 42, timeout_s=5)))
        deadline = time.monotonic() + 5
        while sched.stats()["queued"] and time.monotonic() < deadline:
            time.sleep(0.01)
        st = sched.stats()
        out.append((st["rejected"], st["queued"]))
    finally:
        sched.shutdown()
    out.append(_outcome(lambda: sched.submit(lambda: None)))
    return out


def test_query_scheduler_matches_the_reference():
    got = _scheduler_sequence(tsched)
    ref = _scheduler_sequence(jsched)
    assert got == ref
    assert got[0] == "SchedulerBusy"
    assert got[2][:2] == [("admin",), ("meta",)]
    assert got[3][0] == "ZeroDivisionError" and got[4] == ("ok", 42)


@pytest.mark.parametrize("residency", ("off", "gauge"))
def test_estimate_cost_equals_the_reference(residency):
    pair = make_pair(residency)
    jeng, teng = pair.engines(max_concurrent_cost=1e12)
    jsh, tsh = pair.shards()
    assert tsh.store._val_compressed == (residency == "gauge")
    assert jsh.store._val_compressed == tsh.store._val_compressed
    for q in COST_QUERIES:
        for rng in (RANGE, (RANGE[0], RANGE[1], 10_000)):
            got = teng.estimate_cost(tpromql.query_to_logical_plan(q, *rng))
            ref = jeng.estimate_cost(jpromql.query_to_logical_plan(q, *rng))
            assert got == ref, (q, rng, got, ref)
    base = teng.estimate_cost(tpromql.query_to_logical_plan(
        "sum(rate(m[2m]))", *RANGE))
    # 8 series x 7 steps x 4 window steps, halved on the narrow store
    assert base == 8 * 7 * 4 * (0.5 if residency == "gauge" else 1.0)


def test_shed_raises_and_lands_in_stats_and_the_slow_log():
    pair = make_pair()
    jeng, teng = pair.engines(max_concurrent_cost=1_000_000,
                              shed_retry_after_s=3.0,
                              slow_log_threshold_ms=None)
    with slow_logs_cleared():
        for eng, mod in ((jeng, jsched), (teng, tsched)):
            hogged = eng.admission.acquire(999_999)
            try:
                with pytest.raises(mod.AdmissionRejected) as ei:
                    eng.query_range("sum(rate(m[2m]))", *RANGE,
                                    tenant="grafana")
            finally:
                eng.admission.release(hogged)
            assert ei.value.retry_after_s == 3.0 and ei.value.cost == 224.0
            assert eng.admission.stats()["in_use"] == 0.0
            r = eng.query_range("sum(rate(m[2m]))", *RANGE, tenant="grafana")
            assert r.matrix.num_series == 1
        got = tengine.slow_query_log.entries()
        ref = jengine.slow_query_log.entries()
        assert slow_entries(tengine.slow_query_log) == \
            slow_entries(jengine.slow_query_log)
        assert len(got) == 1 and got[0]["shed"] and got[0]["tenant"] == \
            ref[0]["tenant"] == "grafana"
        assert got[0]["cost"] == ref[0]["cost"] == 224.0
        assert got[0]["stats"]["admission_shed"] == 1
        assert got[0]["error"].startswith("AdmissionRejected")


def test_oversized_cost_is_a_plain_query_error():
    pair = make_pair()
    jeng, teng = pair.engines(max_concurrent_cost=5)
    for eng, err, rej in ((jeng, JQueryError, jsched.AdmissionRejected),
                          (teng, QueryError, tsched.AdmissionRejected)):
        with pytest.raises(err) as ei:
            eng.query_range("sum(rate(m[2m]))", *RANGE)
        assert not isinstance(ei.value, rej)
        assert "never be admitted" in str(ei.value)
    jeng, teng = pair.engines(tenant_quotas={"small": 1.0})
    for eng, err in ((jeng, JQueryError), (teng, QueryError)):
        with pytest.raises(err):
            eng.query_range("sum(rate(m[2m]))", *RANGE, tenant="small")
    jr = jeng.query_range("sum(rate(m[2m]))", *RANGE, tenant="big")
    tr = teng.query_range("sum(rate(m[2m]))", *RANGE, tenant="big")
    assert counters(tr) == counters(jr)
    np.testing.assert_array_equal(np.asarray(tr.matrix.to_host().values),
                                  np.asarray(jr.matrix.to_host().values))
    assert teng.admission.stats()["in_use"] == 0.0


def test_admission_off_by_default_and_span_recorded():
    from filodb_tpu_torch.utils.tracing import SPAN_QUERY_ADMIT, tracer
    pair = make_pair()
    jeng, teng = pair.engines()
    assert teng.admission is jeng.admission is None
    assert teng.result_cache is teng.negative_cache is None
    assert teng.fragment_cache is None
    _j, teng = pair.engines(max_concurrent_cost=1e9)
    n0 = sum(1 for s in tracer.snapshot() if s.name == SPAN_QUERY_ADMIT)
    teng.query_range("sum(rate(m[2m]))", *RANGE, tenant="t")
    spans = [s for s in tracer.snapshot() if s.name == SPAN_QUERY_ADMIT]
    assert len(spans) == n0 + 1
    assert spans[-1].tags == {"tenant": "t", "cost": 224.0}
