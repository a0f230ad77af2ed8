"""parse_plan_ms: host ms a query spends in PromQL parsing and planning,
the program's ``QueryStats.stage_ms["parse"] + ["plan"]``, mean over the
window's answered queries (layer: promql/parser.py, query/planner.py)."""


def read(run):
    ms = [r.stage_ms.get("parse", 0.0) + r.stage_ms.get("plan", 0.0)
          for r in run.requests if r.ok and r.stage_ms]
    return sum(ms) / len(ms) if ms else None
