"""filolint for the port (``filodb_tpu_torch/analysis``), held against the
reference's analyzer (``filodb_tpu/analysis``) and against the port's tree.

  (a) every reference fixture of the eight families ported as they are
      (lock, except, resource, live, epoch, wire, surface, index) gives the
      port's analyzer the same (rule, line) set as the reference's; the
      wire fixtures, which need a spec, get the same spec in both;
  (b) the port's own fixtures (tests/fixtures/filolint_torch/): the
      decode-registry rule in the port's terms and the device-sync kind of
      the liveness rules flag their bad twins and pass their good twins;
  (c) the port's tree analyzes to zero unsuppressed findings with an empty
      baseline (one run, module-scoped);
  (d) the CLI: exit status, --format json|sarif, --changed-only, the
      baseline's refusal of a missing reason;
  (e) the declared lock taxonomy: LATENCY_SPEC["locks"] against LOCK_ORDER,
      the static order against the runtime one.
"""

from __future__ import annotations

import ast
import json
import subprocess
import textwrap
from pathlib import Path

import pytest

from filodb_tpu import analysis as ref_analysis
from filodb_tpu.analysis.wirecheck import WireChecker as RefWireChecker
from filodb_tpu_torch import analysis
from filodb_tpu_torch.analysis import (Baseline, analyze_file, run_analysis)
from filodb_tpu_torch.analysis import __main__ as cli
from filodb_tpu_torch.analysis.findings import (Finding, is_suppressed,
                                                load_suppressions)
from filodb_tpu_torch.analysis.lockcheck import LOCK_ORDER as STATIC_ORDER
from filodb_tpu_torch.analysis.runner import ALL_RULES, DEFAULT_BASELINE
from filodb_tpu_torch.analysis.wirecheck import WIRE_SPEC, WireChecker
from filodb_tpu_torch.utils import diagnostics
from filodb_tpu_torch.utils.diagnostics import LATENCY_SPEC, LOCK_ORDER

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "fixtures" / "filolint"
FIXTURES = REPO / "tests" / "fixtures" / "filolint_torch"

# reference fixtures of the families with no port (jitcheck, meshcheck) or
# a port in other terms (decodecheck: its fixtures are under FIXTURES)
NOT_PORTED_AS_IS = ("_jit_", "_mesh_", "_decode_")


def _ref_fixtures():
    return sorted(p.name for p in REF_FIXTURES.glob("*.py")
                  if not any(k in p.name for k in NOT_PORTED_AS_IS))


def _rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


# -- (a) parity with the reference's analyzer ---------------------------------

def test_reference_fixture_set_is_the_eight_families():
    names = _ref_fixtures()
    assert len(names) == 60
    assert {n.replace("bad_", "").replace("good_", "") for n in names} >= {
        "lock_call.py", "except_swallow.py", "thread_leak.py",
        "live_block.py", "epoch_bump.py", "wire.py", "metric_dup.py",
        "index_postings.py", "stale_ignore.py"}


@pytest.mark.parametrize("name", _ref_fixtures())
def test_reference_fixture_matches_reference_analyzer(name):
    path = REF_FIXTURES / name
    ref = _rule_lines(ref_analysis.analyze_file(path, root=REPO))
    port = _rule_lines(analyze_file(path, root=REPO))
    assert port == ref, f"{name}: port {port} != reference {ref}"
    if name.startswith("bad_") and name not in (
            "bad_wire.py", "bad_wire_ops.py", "bad_store_ops.py",
            "bad_cluster_ops.py", "bad_trace_wire.py"):
        assert port, f"{name} must trip its rules"
    if name.startswith("good_"):
        assert port == [], f"{name} must be clean"


def _spec(module_rel, **over):
    spec = {"wire_module": "<none>", "classifier_module": "<none>",
            "error_base_modules": [], "codec_pairs": [],
            "depth_pair": ("_enc_plan", "_dec_plan"),
            "error_root": "QueryError"}
    spec.update(over)
    return spec


def _codec_spec(codec, classifier=None):
    return _spec(codec, wire_module=codec,
                 classifier_module=classifier or codec,
                 codec_pairs=[("serialize_result", "deserialize_result"),
                              ("pack_multipart", "unpack_multipart")])


def _ops_spec(module, server_fn, client_class):
    return _spec(module, op_specs=[{"module": module, "prefix": "OP_",
                                    "server_fn": server_fn,
                                    "client_class": client_class}])


def _trace_spec(module):
    return _spec(module, trace_specs=[
        {"symbol": "pack_trace_hdr", "sides": [[module, "Client"]]},
        {"symbol": "unpack_trace_hdr", "sides": [[module, "_serve"]]}])


_FX = "tests/fixtures/filolint/"
# the reference test's spec-driven wire runs, one case per (fixture, spec)
WIRE_CASES = {
    "codec-bad": _codec_spec(_FX + "bad_wire.py"),
    "codec-bad-no-dispatch": _codec_spec(_FX + "bad_wire.py",
                                         _FX + "good_jit_closure.py"),
    "codec-good": _codec_spec(_FX + "good_wire.py"),
    "ops-bad": _ops_spec(_FX + "bad_wire_ops.py", "_serve", "Client"),
    "ops-good": _ops_spec(_FX + "good_wire_ops.py", "_serve", "Client"),
    "store-bad": _ops_spec(_FX + "bad_store_ops.py", "_serve",
                           "RemoteStore"),
    "store-good": _ops_spec(_FX + "good_store_ops.py", "_serve",
                            "RemoteStore"),
    "cluster-bad": _ops_spec(_FX + "bad_cluster_ops.py", "serve_cluster",
                             "ClusterLink"),
    "cluster-good": _ops_spec(_FX + "good_cluster_ops.py", "serve_cluster",
                              "ClusterLink"),
    "trace-bad": _trace_spec(_FX + "bad_trace_wire.py"),
    "trace-good": _trace_spec(_FX + "good_trace_wire.py"),
}


def _wire_run(checker_cls, spec):
    w = checker_cls(spec=spec)
    mods = {spec["wire_module"], spec["classifier_module"]}
    mods |= {s["module"] for s in spec.get("op_specs", [])}
    mods |= {m for t in spec.get("trace_specs", []) for m, _ in t["sides"]}
    for rel in sorted(mods):
        if (REPO / rel).exists():
            w.check_module(rel, ast.parse((REPO / rel).read_text()))
    return sorted((f.rule, f.line, f.detail) for f in w.finalize())


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_fixture_matches_reference_analyzer(case):
    spec = WIRE_CASES[case]
    ref = _wire_run(RefWireChecker, spec)
    port = _wire_run(WireChecker, spec)
    assert port == ref
    assert bool(port) == case.split("-")[1].startswith("bad"), port


# -- (b) the port's own fixtures ----------------------------------------------

PORT_BAD = {
    "bad_decode_variant.py": {
        ("surface-decode-variant-twin", "none:quant16:decode"),
        ("surface-decode-variant-twin", "missing:delta8:decode"),
        ("surface-decode-variant-twin", "no-kernel:delta16"),
        ("surface-decode-variant-twin", "no-twin:delta4")},
    "bad_live_device_sync.py": {
        ("live-block-under-lock", "shard:item"),
        ("live-block-under-lock", "shard:cpu"),
        ("live-block-under-lock", "shard:synchronize")},
}


@pytest.mark.parametrize("name", sorted(PORT_BAD))
def test_port_bad_fixture_is_flagged(name):
    got = {(f.rule, f.detail) for f in analyze_file(FIXTURES / name,
                                                     root=REPO)}
    assert got == PORT_BAD[name]


@pytest.mark.parametrize("name", sorted(PORT_BAD))
def test_port_good_twin_is_clean(name):
    good = name.replace("bad_", "good_")
    findings = analyze_file(FIXTURES / good, root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_device_sync_fixture_spec_is_the_ports():
    """The fixtures' blocking table is the port's device-sync kind as
    utils/diagnostics.py declares it."""
    tree = ast.parse((FIXTURES / "bad_live_device_sync.py").read_text())
    spec = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and n.targets[0].id == "LATENCY_SPEC")
    declared = {k for k, v in LATENCY_SPEC["blocking"].items()
                if v == "device-sync"}
    assert set(spec["blocking"]) == declared == {"cpu", "item",
                                                 "synchronize"}


def test_decode_rule_holds_the_real_registry_against_kind_codes():
    """The port's registry and K1's variant codes pair up today, and a
    scoped run holding only one side judges nothing."""
    from filodb_tpu_torch.ops import decodereg, fusedgrid
    assert set(decodereg.DECODE_VARIANTS) == set(fusedgrid.KIND_CODES)
    assert all(v.decode is not None
               for v in decodereg.DECODE_VARIANTS.values())
    rep = run_analysis(REPO, paths=["filodb_tpu_torch/ops/decodereg.py"],
                       baseline_path=None)
    assert not [f for f in rep.all_findings
                if f.rule == "surface-decode-variant-twin"]


# -- (c) the port's tree ------------------------------------------------------

@pytest.fixture(scope="module")
def tree_report():
    return run_analysis(REPO)


def test_tree_has_zero_unsuppressed_findings(tree_report):
    assert tree_report.files_analyzed > 100
    assert all(p.startswith("filodb_tpu_torch/")
               for p in tree_report.analyzed_paths)
    assert tree_report.new == [], "\n".join(f.render()
                                            for f in tree_report.new)


def test_baseline_is_empty(tree_report):
    assert DEFAULT_BASELINE == "filodb_tpu_torch/analysis/baseline.json"
    assert Baseline.load(REPO / DEFAULT_BASELINE).entries == []
    assert tree_report.baselined == []


def test_each_inline_suppression_names_a_live_finding(tree_report):
    """The suppressed findings are exactly the ones the tree carries an
    inline ignore for (no stale ignore survives a full run), and the
    lead the dry run raised is among them."""
    assert not [f for f in tree_report.all_findings
                if f.rule == "filolint-stale-ignore"]
    got = {(f.rule, f.path) for f in tree_report.suppressed}
    assert ("epoch-undeclared-visibility", "filodb_tpu_torch/entry.py") \
        in got
    assert {r for r, _ in got} <= {"epoch-undeclared-visibility",
                                   "except-swallow",
                                   "surface-config-unused"}


def test_the_leads_are_fixed(tree_report):
    """query/exec.py reaches gather_resident_locked through a helper that
    holds the shard lock; ops/decodereg.py registers plain twins."""
    for f in tree_report.all_findings:
        assert not (f.rule == "lock-unheld-call"
                    and f.path == "filodb_tpu_torch/query/exec.py"), f
        assert f.rule != "surface-decode-variant-twin", f


def test_import_isolation_walks_every_analysis_module():
    from tests.test_torch_import_isolation import port_modules
    mods = set(port_modules())
    pkg = REPO / "filodb_tpu_torch" / "analysis"
    for p in pkg.glob("*.py"):
        name = p.stem if p.stem != "__init__" else ""
        full = "filodb_tpu_torch.analysis" + (f".{name}" if name else "")
        assert full in mods, full
    assert not (pkg / "jitcheck.py").exists()
    assert not (pkg / "meshcheck.py").exists()


def test_importing_the_cli_runs_nothing(capsys):
    import importlib
    importlib.reload(cli)
    assert capsys.readouterr().out == ""


# -- (d) the CLI --------------------------------------------------------------

SWALLOW = ("def f(x):\n"
           "    try:\n"
           "        return x()\n"
           "    except Exception:\n"
           "        pass\n")


def test_cli_exit_status_on_the_tree(tree_report, monkeypatch):
    monkeypatch.setattr(cli, "run_analysis", lambda *a, **k: tree_report)
    assert cli.main(["--root", str(REPO), "--quiet"]) == 0


def test_cli_exit_status_on_a_finding(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text(SWALLOW)
    assert cli.main(["--root", str(tmp_path), str(bad), "--quiet"]) == 1
    bad.write_text(SWALLOW.replace("except Exception:",
                                   "except Exception:  # filolint: "
                                   "ignore[except-swallow]"))
    assert cli.main(["--root", str(tmp_path), str(bad), "--quiet"]) == 0


def test_output_formats_are_machine_readable(tree_report, monkeypatch,
                                             capsys):
    monkeypatch.setattr(cli, "run_analysis", lambda *a, **k: tree_report)
    assert cli.main(["--root", str(REPO), "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["new"] == 0 and report["files_analyzed"] > 100
    assert report["counts"]["suppressed"] == len(tree_report.suppressed)
    assert cli.main(["--root", str(REPO), "--format", "sarif"]) == 0
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert run["tool"]["driver"]["name"] == "filolint"
    assert run["results"] == []
    assert tuple(r["id"] for r in run["tool"]["driver"]["rules"]) \
        == ALL_RULES


def test_sarif_and_json_carry_a_finding(tmp_path, capsys):
    bad = tmp_path / "m.py"
    bad.write_text(SWALLOW)
    assert cli.main(["--root", str(tmp_path), str(bad), "--format",
                     "sarif"]) == 1
    res = json.loads(capsys.readouterr().out)["runs"][0]["results"]
    assert [r["ruleId"] for r in res] == ["except-swallow"]
    assert cli.main(["--root", str(tmp_path), str(bad), "--format",
                     "json"]) == 1
    assert json.loads(capsys.readouterr().out)["counts"]["new"] == 1


def test_rule_set_is_the_reference_less_the_unported_families():
    ref = set(ref_analysis.ALL_RULES)
    dropped = {r for r in ref if r.startswith(("jit-", "mesh-"))}
    assert dropped and set(ALL_RULES) == ref - dropped


def _git(cwd, *args):
    subprocess.run(["git", *args], cwd=cwd, check=True,
                   capture_output=True)


def test_changed_only_rebases_paths_below_git_toplevel(tmp_path):
    sub = tmp_path / "vendor" / "repo"
    (sub / "filodb_tpu_torch").mkdir(parents=True)
    (sub / "filodb_tpu").mkdir(parents=True)
    _git(tmp_path, "init", "-q")
    (sub / "filodb_tpu_torch" / "x.py").write_text("x = 1\n")
    (sub / "filodb_tpu" / "y.py").write_text("y = 1\n")
    _git(tmp_path, "add", "-A")
    # the JAX package's files are not the port's, whatever their prefix
    assert cli._changed_files(sub) == ["filodb_tpu_torch/x.py"]


def test_changed_only_analyzes_changed_files_and_anchors(tmp_path, capsys):
    pkg = tmp_path / "filodb_tpu_torch"
    pkg.mkdir()
    _git(tmp_path, "init", "-q")
    (pkg / "m.py").write_text(SWALLOW)
    _git(tmp_path, "add", "-A")
    assert cli.main(["--root", str(tmp_path), "--changed-only",
                     "--quiet"]) == 1
    assert "1 files analyzed" in capsys.readouterr().out


def test_changed_only_with_nothing_changed(tmp_path, capsys):
    (tmp_path / "filodb_tpu").mkdir()
    _git(tmp_path, "init", "-q")
    (tmp_path / "filodb_tpu" / "m.py").write_text(SWALLOW)
    _git(tmp_path, "add", "-A")
    assert cli.main(["--root", str(tmp_path), "--changed-only",
                     "--quiet"]) == 0
    assert "nothing to analyze" in capsys.readouterr().out


@pytest.mark.parametrize("changed", [
    "filodb_tpu_torch/analysis/newrule.py",
    "tests/fixtures/filolint_torch/bad_new.py",
    "tests/fixtures/filolint/bad_new.py"])
def test_changed_only_escalates_on_analysis_changes(tmp_path, capsys,
                                                    changed):
    p = tmp_path / changed
    p.parent.mkdir(parents=True)
    _git(tmp_path, "init", "-q")
    p.write_text("x = 1\n")
    _git(tmp_path, "add", "-A")
    assert cli.main(["--root", str(tmp_path), "--changed-only",
                     "--quiet"]) == 0
    assert "escalating" in capsys.readouterr().err


def test_anchor_modules_are_the_ports():
    for a in cli.ANCHOR_MODULES:
        assert a.startswith("filodb_tpu_torch/") and (REPO / a).exists(), a
    for spec_module in ("core/memstore.py", "utils/diagnostics.py",
                        "utils/metrics.py", "utils/tracing.py", "config.py",
                        "ops/decodereg.py", "ops/fusedgrid.py"):
        assert f"filodb_tpu_torch/{spec_module}" in cli.ANCHOR_MODULES


def test_baseline_write_refuses_missing_reason(tmp_path):
    f = Finding("except-swallow", "m.py", 3, "f", "swallow:1", "msg")
    with pytest.raises(ValueError):
        Baseline.write(tmp_path / "b.json", [f])
    Baseline.write(tmp_path / "b.json", [f], reason="intentional: probe")
    b = Baseline.load(tmp_path / "b.json")
    assert b.covers(f) and b.entries[0]["reason"] == "intentional: probe"


def test_update_baseline_cli_refuses_without_reason(tmp_path):
    bad = tmp_path / "bad_swallow.py"
    bad.write_text(SWALLOW)
    bl = tmp_path / "bl.json"
    rc = cli.main(["--root", str(tmp_path), str(bad), "--baseline", str(bl),
                   "--update-baseline", "--quiet"])
    assert rc == 2 and not bl.exists()
    rc = cli.main(["--root", str(tmp_path), str(bad), "--baseline", str(bl),
                   "--update-baseline", "--reason", "fixture: deliberate"])
    assert rc == 0 and bl.exists()
    assert cli.main(["--root", str(tmp_path), str(bad), "--baseline",
                     str(bl), "--quiet"]) == 0


def test_update_baseline_narrow_scope_preserves_out_of_scope_entries(
        tmp_path):
    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text(SWALLOW)
    b.write_text(SWALLOW)
    bl = tmp_path / "bl.json"
    assert cli.main(["--root", str(tmp_path), str(a), str(b), "--baseline",
                     str(bl), "--update-baseline", "--reason",
                     "fixture"]) == 0
    assert cli.main(["--root", str(tmp_path), str(a), "--baseline", str(bl),
                     "--update-baseline", "--reason", "fixture"]) == 0
    entries = json.loads(bl.read_text())["entries"]
    assert {e["file"] for e in entries} == {"a.py", "b.py"}


def test_include_tools_audit_is_warnings_only(tree_report, monkeypatch,
                                              capsys):
    monkeypatch.setattr(cli, "run_analysis", lambda *a, **k: tree_report)
    assert cli.main(["--root", str(REPO), "--quiet",
                     "--include-tools"]) == 0
    capsys.readouterr()
    assert cli.TOOLS == ("chip_smoke.py", "scripts/profile_torch_query.py")
    assert all((REPO / t).exists() for t in cli.TOOLS)
    for line in cli._tools_audit(REPO):
        assert line.startswith("filolint: tools-audit")
        assert "utils/diagnostics.py" not in line.split("]")[0]


def test_tools_audit_reads_the_ports_tools(tmp_path):
    """A tool that blocks under a declared lock is reported, as a warning
    line, with the port's liveness contract in scope."""
    (tmp_path / "scripts").mkdir()
    (tmp_path / "filodb_tpu_torch" / "utils").mkdir(parents=True)
    (tmp_path / "filodb_tpu_torch" / "utils" / "diagnostics.py").write_text(
        (REPO / "filodb_tpu_torch/utils/diagnostics.py").read_text())
    (tmp_path / "chip_smoke.py").write_text(
        "def f(shard, t):\n"
        "    with shard.lock:\n"
        "        return t.item()\n")
    lines = cli._tools_audit(tmp_path)
    assert len(lines) == 1 and "chip_smoke.py:3" in lines[0]
    assert "live-block-under-lock" in lines[0]


# -- the engine's mechanics (the reference's own cases, on the port) ----------

def test_inline_suppression(tmp_path):
    src = ("import threading\n"
           "class S:\n"
           "    def __init__(self):\n"
           "        self.lock = threading.RLock()\n"
           "    def _f_locked(self):\n"
           "        pass\n"
           "    def g(self):\n"
           "        self._f_locked()  # filolint: ignore[lock-unheld-call]\n")
    p = tmp_path / "supp.py"
    p.write_text(src)
    assert analyze_file(p, root=tmp_path) == []
    p.write_text(src.replace("  # filolint: ignore[lock-unheld-call]", ""))
    assert [f.rule for f in analyze_file(p, root=tmp_path)] \
        == ["lock-unheld-call"]


def test_skip_file_suppression():
    supp = load_suppressions("# filolint: skip-file\nx = 1\n")
    f = Finding("lock-unheld-call", "x.py", 2, "m", "d", "msg")
    assert is_suppressed(f, supp)


def test_baseline_matches_by_fingerprint_not_line():
    f = Finding("lock-unheld-call", "pkg/m.py", 10, "C.m", "call:_x_locked",
                "msg")
    b = Baseline([{"rule": "lock-unheld-call", "file": "pkg/m.py",
                   "symbol": "C.m", "detail": "call:_x_locked",
                   "reason": "caller holds by contract"}])
    assert b.covers(f)
    assert b.covers(Finding("lock-unheld-call", "pkg/m.py", 99, "C.m",
                            "call:_x_locked", "msg"))
    assert not b.covers(Finding("lock-unheld-call", "pkg/m.py", 10, "C.n",
                                "call:_x_locked", "msg"))


def test_helper_held_lock_and_escaped_reference(tmp_path):
    """A private helper whose every call site holds the lock inherits the
    hold (the shape query/exec.py's paged gather takes); the same helper
    passed as a thread target does not."""
    src = ("import threading\n"
           "class C:\n"
           "    def __init__(self):\n"
           "        self.lock = threading.RLock()\n"
           "    def _bump_locked(self):\n"
           "        pass\n"
           "    def _bump(self):\n"
           "        self._bump_locked()\n"
           "    def kick(self):\n"
           "        with self.lock:\n"
           "            self._bump()\n")
    p = tmp_path / "helper.py"
    p.write_text(src)
    assert analyze_file(p, root=tmp_path) == []
    p.write_text(src + "        threading.Thread(target=self._bump, "
                       "daemon=True).start()\n")
    assert any(f.rule == "lock-unheld-call" and f.symbol == "C._bump"
               for f in analyze_file(p, root=tmp_path))


def test_may_raise_propagates_through_helpers():
    from filodb_tpu_torch.analysis.callgraph import PackageIndex
    src = textwrap.dedent("""
        class QueryError(Exception):
            pass
        def a():
            raise QueryError("x")
        def b():
            return a()
        def c():
            try:
                return b()
            except QueryError:
                return None
    """)
    mr = PackageIndex({"m.py": ast.parse(src)}).may_raise(
        typed_only={"QueryError"})
    assert "QueryError" in mr["m.py::a"] and "QueryError" in mr["m.py::b"]
    assert "QueryError" not in mr["m.py::c"]


def test_release_leak_through_nonmatching_handler(tmp_path):
    bad = ("def f(p, use):\n"
           "    fh = open(p)\n"
           "    try:\n"
           "        use(fh)\n"
           "    except ValueError:\n"
           "        pass\n"
           "    fh.close()\n")
    p = tmp_path / "leak.py"
    p.write_text(bad)
    assert any(f.rule == "resource-no-release"
               for f in analyze_file(p, root=tmp_path))
    p.write_text(bad.replace("        pass\n    fh.close()\n",
                             "        pass\n    finally:\n"
                             "        fh.close()\n"))
    assert analyze_file(p, root=tmp_path) == []


def test_stale_ignore_only_suppressed_by_naming_itself(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    return 1  # filolint: ignore[lock-order]\n")
    assert any(f.rule == "filolint-stale-ignore"
               for f in analyze_file(p, root=tmp_path))
    p.write_text("def f():\n    return 1  "
                 "# filolint: ignore[lock-order, filolint-stale-ignore]\n")
    assert analyze_file(p, root=tmp_path) == []


def test_shared_corpus_matches_per_family(tmp_path):
    """Both cost models give fingerprint-identical findings (on a small
    tree: no wall-clock assertion)."""
    (tmp_path / "a.py").write_text(SWALLOW)
    (tmp_path / "b.py").write_text(
        "import threading\n"
        "def start(fn):\n"
        "    threading.Thread(target=fn).start()\n")
    paths = [str(tmp_path / "a.py"), str(tmp_path / "b.py")]
    shared = run_analysis(tmp_path, paths, baseline_path=None)
    legacy = run_analysis(tmp_path, paths, baseline_path=None,
                          shared_corpus=False)
    assert shared.all_findings
    assert sorted(f.fingerprint for f in shared.all_findings) \
        == sorted(f.fingerprint for f in legacy.all_findings)
    assert shared.corpus_stats["index_builds"] == 1


# -- wire specs name the port's functions -------------------------------------

def test_wire_spec_names_exist_in_the_port():
    def defined(module, name):
        tree = ast.parse((REPO / module).read_text())
        return any(isinstance(n, (ast.FunctionDef, ast.ClassDef))
                   and n.name == name for n in ast.walk(tree))
    assert all(m.startswith("filodb_tpu_torch/") for m in
               [WIRE_SPEC["wire_module"], WIRE_SPEC["classifier_module"],
                *WIRE_SPEC["error_base_modules"]])
    for enc, dec in WIRE_SPEC["codec_pairs"]:
        assert defined(WIRE_SPEC["wire_module"], enc)
        assert defined(WIRE_SPEC["wire_module"], dec)
    for op in WIRE_SPEC["op_specs"]:
        assert defined(op["module"], op["server_fn"]), op
        assert defined(op["module"], op["client_class"]), op
        assert "OP_" in (REPO / op["module"]).read_text()
    for spec in WIRE_SPEC["trace_specs"]:
        for module, scope in spec["sides"]:
            assert defined(module, scope), (module, scope)


@pytest.mark.parametrize("module", sorted(
    {s["module"] for s in WIRE_SPEC["op_specs"]}))
def test_port_op_tags_are_exhaustive(module):
    w = WireChecker()
    w.check_module(module, ast.parse((REPO / module).read_text()))
    findings = w.finalize()
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_trace_carriers_are_two_sided():
    w = WireChecker()
    for spec in WIRE_SPEC["trace_specs"]:
        for module, _scope in spec["sides"]:
            if module not in w._modules:
                w.check_module(module,
                               ast.parse((REPO / module).read_text()))
    findings = [f for f in w.finalize() if f.rule == "wire-trace-parity"]
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_wire_module_tags_are_exhaustive():
    from filodb_tpu_torch.analysis.wirecheck import _byte_tags, _functions
    fns = _functions(ast.parse(
        (REPO / "filodb_tpu_torch/query/wire.py").read_text()))
    enc = set(_byte_tags(fns["serialize_result"]))
    dec = set(_byte_tags(fns["deserialize_result"]))
    assert enc == dec and {b"A", b"T", b"S", b"C", b"M"} <= enc


# -- (e) the lock taxonomy ----------------------------------------------------

def test_latency_spec_lock_classes_match_runtime_order():
    assert set(LATENCY_SPEC["locks"].values()) == set(LOCK_ORDER)
    for section in ("sites", "wait_ok", "retry_ok"):
        for name, site in LATENCY_SPEC.get(section, {}).items():
            assert site.get("fn"), (section, name)
            assert str(site.get("reason", "")).strip(), (section, name)


def test_lock_order_declared_once():
    assert STATIC_ORDER == LOCK_ORDER


def test_latency_spec_is_the_references_plus_device_sync():
    from filodb_tpu.utils.diagnostics import LATENCY_SPEC as REF
    assert LATENCY_SPEC["locks"] == REF["locks"]
    assert LATENCY_SPEC["blocking_attr_calls"] == REF["blocking_attr_calls"]
    extra = {k: v for k, v in LATENCY_SPEC["blocking"].items()
             if k not in REF["blocking"]}
    assert extra == {"cpu": "device-sync", "item": "device-sync",
                     "synchronize": "device-sync"}
    assert all(LATENCY_SPEC["blocking"][k] == v
               for k, v in REF["blocking"].items())


def test_runtime_lock_order_assert_fires():
    was = diagnostics.lock_debug
    diagnostics.enable_lock_debug(True)
    try:
        shard = diagnostics.TimedRLock("t-shard", order_class="shard",
                                       order_index=0)
        shard1 = diagnostics.TimedRLock("t-shard-1", order_class="shard",
                                        order_index=1)
        sink = diagnostics.TimedRLock("t-sink", order_class="sink")
        grp = diagnostics.TimedRLock("t-grp", order_class="group_flush")
        with grp, sink, shard, shard, shard1:
            pass
        with shard:
            with pytest.raises(diagnostics.DiagnosticsError):
                sink.acquire()
        with shard1:
            with pytest.raises(diagnostics.DiagnosticsError):
                shard.acquire()
        with grp, sink, shard:
            pass
    finally:
        diagnostics.enable_lock_debug(was)


def test_memstore_locks_are_ordered():
    from filodb_tpu_torch.core.memstore import StoreConfig, TimeSeriesMemStore
    ms = TimeSeriesMemStore(device="cpu")
    sh = ms.setup("lintcheck", "gauge", 0,
                  StoreConfig(max_series_per_shard=8, samples_per_series=16))
    assert sh.lock.order_class == "shard"
    assert sh._sink_lock.order_class == "sink"
    assert all(lk.order_class == "group_flush"
               for lk in sh._group_flush_locks)


def test_package_docstring_names_what_has_no_port():
    doc = analysis.__doc__
    assert "jitcheck" in doc and "meshcheck" in doc and "device-sync" in doc
