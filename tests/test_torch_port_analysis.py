"""The port's offline analyzer (``horovod_tpu_torch/analysis/``) against the
JAX package's, on the CPU.

Every ``.py`` fixture under ``tests/lint_fixtures/`` (``perf/`` included)
gives the same findings (rule, severity, file, line, message) from both
packages in ``lint``, ``verify`` and ``perf``, and so does a copy of each
fixture spelled against ``horovod_tpu_torch``. The port's SARIF equals
the golden files; ``explain`` of the golden postmortem bundle, ``fit_shards``
over the same shard files, the step prediction and the CLI give the JAX
package's answers. ``--self`` sweeps the port clean, with only the recorded
HVD306 rows of knobs the port does not read yet in its baseline. The
redistribution programs of ``TwoDZero`` prove clean under hvd-sim.
"""

import functools
import glob
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from horovod_tpu.analysis import (ast_lint as j_ast, costmodel as j_cost,
                                  explain as j_explain, simulate as j_sim)
from horovod_tpu.analysis import cli as j_cli
from horovod_tpu_torch import analysis as t_analysis
from horovod_tpu_torch.analysis import (ast_lint as t_ast, baseline as t_base,
                                        cli as t_cli, costmodel as t_cost,
                                        explain as t_explain, sarif as t_sarif,
                                        simulate as t_sim)
from horovod_tpu_torch.analysis.diagnostics import Diagnostic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
PERF_FIXTURES = os.path.join(FIXTURES, "perf")
FIXTURE_TABLE = os.path.join(PERF_FIXTURES, "costmodel_table.json")
BUNDLE = os.path.join(FIXTURES, "postmortem_bundle")
PROGRAM = os.path.join(FIXTURES, "sim_explain_program.py")
RANKS = [8, 64, 256, 1024]
FIXTURE_FILES = sorted(os.path.relpath(p, FIXTURES) for p in glob.glob(
    os.path.join(FIXTURES, "**", "*.py"), recursive=True))
JAX = types.SimpleNamespace(ast=j_ast, sim=j_sim, cost=j_cost)
PORT = types.SimpleNamespace(ast=t_ast, sim=t_sim, cost=t_cost)


def _torch_spelled(src):
    return re.sub(r"\bhorovod_tpu\b", "horovod_tpu_torch", src)


@pytest.fixture(scope="module")
def torch_fixtures(tmp_path_factory):
    """A copy of every fixture with ``horovod_tpu`` spelled
    ``horovod_tpu_torch``."""
    root = str(tmp_path_factory.mktemp("torch_spelled"))
    for rel in FIXTURE_FILES:
        dst = os.path.join(root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(os.path.join(FIXTURES, rel)) as f:
            src = f.read()
        with open(dst, "w") as f:
            f.write(_torch_spelled(src))
    return root


@functools.lru_cache(maxsize=None)
def _findings(pkg_name, path):
    """``{mode: [finding]}`` of one file, one verifier for verify and perf
    (as the CLI runs them)."""
    pkg = JAX if pkg_name == "jax" else PORT
    base = pkg.ast.lint_paths([path])
    verifier = pkg.sim.Verifier()
    verifier.add_path(path)
    verify = base + pkg.sim.run_combined(verifier)
    perf = verify + pkg.cost.perf_diagnostics(
        verifier, table=pkg.cost.load_table(FIXTURE_TABLE),
        target_ranks=RANKS)
    root = os.path.dirname(path)
    return {mode: sorted(_view(d, root) for d in diags)
            for mode, diags in (("lint", base), ("verify", verify),
                                ("perf", perf))}


def _view(d, root):
    """A finding with the fixture directory and the package spelling
    taken out of its file and message."""
    msg = d.message.replace(os.path.relpath(root) + os.sep, "")
    msg = msg.replace(root + os.sep, "").replace("horovod_tpu_torch",
                                                 "horovod_tpu")
    return (d.rule, d.severity, os.path.relpath(d.file, root), d.line, msg,
            d.hint.replace("horovod_tpu_torch", "horovod_tpu"),
            bool(d.trace))


@pytest.mark.parametrize("mode", ["lint", "verify", "perf"])
@pytest.mark.parametrize("spelling", ["jax", "torch"])
@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_fixture_findings_match_jax(rel, spelling, mode, torch_fixtures):
    want = _findings("jax", os.path.join(FIXTURES, rel))[mode]
    root = FIXTURES if spelling == "jax" else torch_fixtures
    got = _findings("port", os.path.join(root, rel))[mode]
    assert got == want


def test_fixture_corpus_trips_every_family():
    rules = {f[0] for rel in FIXTURE_FILES
             for f in _findings("port", os.path.join(FIXTURES, rel))["perf"]}
    assert {"HVD201", "HVD202", "HVD203", "HVD206", "HVD301",
            "HVD302", "HVD401", "HVD402", "HVD501", "HVD502", "HVD601",
            "HVD602", "HVD603", "HVD704", "HVD705"} <= rules


def test_rule_catalog_is_the_jax_package_s(capsys):
    from horovod_tpu.analysis import diagnostics as jdiag
    assert t_analysis.RULES == jdiag.RULES
    assert t_cli.main(["--list-rules"]) == 0
    port = capsys.readouterr().out
    assert j_cli.main(["--list-rules"]) == 0
    assert port == capsys.readouterr().out


# -- SARIF ------------------------------------------------------------------

def _golden(path):
    with open(path) as f:
        return json.load(f)


def _sarif(doc):
    doc["runs"][0]["tool"]["driver"]["version"] = "GOLDEN"
    return doc


def test_sarif_golden_lint():
    d1 = Diagnostic.make(
        "HVD401", "collective `allreduce` runs only on ranks that "
        "take a rank-dependent path", file="golden/train.py", line=12,
        hint="hoist the collective out of the rank-dependent path")
    d2 = Diagnostic.make(
        "HVD304", "raw os.environ read of 'HVDTPU_DEMO' bypasses "
        "utils/envparse.py", file="golden/train.py", line=40)
    doc = _sarif(t_sarif.to_sarif([d1], suppressed=[d2]))
    assert doc == _golden(os.path.join(FIXTURES, "golden_lint.sarif"))


@pytest.mark.parametrize("spelling", ["horovod_tpu", "horovod_tpu_torch"])
def test_sarif_golden_sim(spelling):
    src = (f"import {spelling} as hvd\n"
           "def exchange(x):\n"
           "    if hvd.rank() == 0:\n"
           "        hvd.allreduce(x, name='alpha')\n"
           "    else:\n"
           "        hvd.allreduce(x, name='beta')\n")
    diags = t_sim.simulate_source(src, "golden/train.py")
    assert [d.rule for d in diags] == ["HVD501"]
    doc = _sarif(t_sarif.to_sarif(diags))
    assert doc == _golden(os.path.join(FIXTURES, "golden_sim.sarif"))


def test_sarif_golden_perf():
    path = os.path.join(PERF_FIXTURES, "bad_bucket_knob.py")
    verifier = t_sim.Verifier()
    verifier.add_path(path)
    diags = t_cost.perf_diagnostics(
        verifier, table=t_cost.load_table(FIXTURE_TABLE),
        target_ranks=RANKS)
    doc = _sarif(t_sarif.to_sarif(diags))
    for result in doc["runs"][0]["results"]:
        loc = result["locations"][0]["physicalLocation"]
        loc["artifactLocation"]["uri"] = \
            "tests/lint_fixtures/perf/bad_bucket_knob.py"
    assert doc == _golden(os.path.join(PERF_FIXTURES, "golden_perf.sarif"))


def test_sarif_tool_version_is_the_port_s(tmp_path):
    from horovod_tpu_torch.version import __version__
    doc = t_sarif.to_sarif([])
    assert doc["runs"][0]["tool"]["driver"]["version"] == __version__
    out = tmp_path / "x.sarif"
    t_sarif.write_sarif(str(out), [Diagnostic.make(
        "HVD501", "m", file="a.py", line=1)])
    assert t_sarif.main([str(out), "--require-rule", "HVD501"]) == 0
    assert t_sarif.main([str(out), "--expect-none"]) == 1


# -- explain ------------------------------------------------------------------

def _explained(mod):
    report = mod.explain_bundle(BUNDLE, [PROGRAM])
    return json.loads(json.dumps(report)), mod.render_report(report)


def test_explain_golden_bundle_matches_jax():
    (t_rep, t_text), (j_rep, j_text) = (_explained(t_explain),
                                        _explained(j_explain))
    assert t_rep == j_rep
    assert t_text == j_text
    div = t_rep["divergence"]
    assert (div["type"], div["rule"], div["name"]) == \
        ("missing_submission", "HVD501", "step3")
    assert div["sources"][0]["line"] == 17


SKIP_BUNDLES = os.path.join(REPO, "tests", "torch_port_fixtures",
                            "skip_slot")
SKIP_WORKER = os.path.join(REPO, "tests", "torch_port_analysis_worker.py")


@pytest.mark.parametrize("where", sorted(os.listdir(SKIP_BUNDLES)))
def test_explain_of_a_port_skip_a_slot_bundle_matches_jax(where, tmp_path):
    # Postmortems of the port's own skip job (rank 1 skips skip3; each
    # rank's watchdog aborts), recorded on the CPU and on two H100s. Both
    # ranks submit their next slot as soon as skip2 completes, so which of
    # skip3 (rank 0's) and skip4 (rank 1's) came first is a race: both
    # packages name the same one on the same bundle, down to the source
    # line of a copy of the worker spelled for each package.
    bundle = os.path.join(SKIP_BUNDLES, where)
    jworker = tmp_path / "worker.py"
    with open(SKIP_WORKER) as f:
        jworker.write_text(re.sub(r"\bhorovod_tpu_torch\b", "horovod_tpu",
                                  f.read()))
    t_rep = json.loads(json.dumps(t_explain.explain_bundle(
        bundle, [SKIP_WORKER])))
    j_rep = json.loads(json.dumps(j_explain.explain_bundle(
        bundle, [str(jworker)])))
    for rep in (t_rep, j_rep):
        for src in rep["divergence"]["sources"]:
            src["file"] = "worker.py"
    assert t_rep == j_rep
    div = t_rep["divergence"]
    assert (div["type"], div["rule"]) == ("missing_submission", "HVD501")
    assert (div["name"], tuple(div["submitted_by"])) in {
        ("skip3", (0,)), ("skip4", (1,))}
    with open(SKIP_WORKER) as f:
        line = next(i for i, text in enumerate(f, start=1)
                    if 'name=f"skip{epoch}"' in text)
    assert [(s["function"], s["line"]) for s in div["sources"]] == \
        [("skip_job", line)]


def test_explain_cli_text_json_and_missing_bundle(tmp_path, capsys):
    for fmt in ("text", "json"):
        assert t_cli.main(["explain", BUNDLE, "--program", PROGRAM,
                           "--format", fmt]) == 0
        port = capsys.readouterr().out
        assert j_cli.main(["explain", BUNDLE, "--program", PROGRAM,
                           "--format", fmt]) == 0
        assert port == capsys.readouterr().out
    assert t_cli.main(["explain", str(tmp_path)]) == 2


# -- perf: calibration and prediction ------------------------------------------

def _write_shards(root, seed=0):
    """Two runs (world 2 and 4), one shard per rank, several kinds: spans
    on an α–β plane with seeded noise, grouped into steps by occurrence."""
    rng = np.random.default_rng(seed)
    kinds = [("allreduce", 1 << 22), ("allgather", 1 << 20),
             ("broadcast", 1 << 16), ("allreduce_async", 1 << 24)]
    for world in (2, 4):
        run = os.path.join(root, f"n{world}")
        os.makedirs(run)
        for rank in range(world):
            recs = [{"e": "meta", "kind": "trace", "rank": rank,
                     "size": world, "ver": 0, "off": 0.0, "t": 0.0}]
            t = 1.0
            for occ in range(6):
                for i, (kind, nbytes) in enumerate(kinds):
                    lat, bw = t_cost._terms(t_cost.canonical_kind(kind),
                                            world)
                    dur = (3e-5 * lat + nbytes * 2e-10 * bw) \
                        * float(rng.uniform(0.9, 1.1))
                    name = f"g{i}"
                    recs.append({"e": "sub", "t": t, "n": name, "o": occ,
                                 "k": kind, "b": nbytes})
                    recs.append({"e": "fin", "t": t + dur, "n": name,
                                 "o": occ, "k": kind})
                    t += dur * 0.5
                t += 0.002
            with open(os.path.join(run, f"shard.r{rank}.v0.jsonl"),
                      "w") as f:
                f.writelines(json.dumps(r) + "\n" for r in recs)
    return [os.path.join(root, f"n{w}") for w in (2, 4)]


def test_fit_shards_matches_jax(tmp_path):
    from horovod_tpu.tracing import merge as jmerge
    from horovod_tpu_torch.tracing import merge as tmerge
    paths = _write_shards(str(tmp_path))
    t_table = t_cost.fit_shards(tmerge.load_paths(paths))
    j_table = j_cost.fit_shards(jmerge.load_paths(paths))
    assert t_table == j_table
    assert t_table["source"] == "calibrated"
    assert t_table["worlds"] == [2, 4]
    assert t_cost.fit_paths(paths) == j_cost.fit_paths(paths)
    with pytest.raises(ValueError, match="no usable collective spans"):
        t_cost.fit_paths([str(tmp_path / "empty")])


def test_table_io_and_prediction_match_jax(tmp_path, monkeypatch):
    table = t_cost.fit_paths(_write_shards(str(tmp_path)))
    out = str(tmp_path / "table.json")
    t_cost.save_table(table, out)
    assert t_cost.load_table(out) == j_cost.load_table(out)
    monkeypatch.setenv("HVDTPU_COSTMODEL_TABLE", out)
    assert t_cost.resolve_table() == j_cost.resolve_table()
    monkeypatch.setenv("HVDTPU_PERF_TARGET_RANKS", "4;2,x,1,16")
    assert t_cost.target_ranks_from_env() == \
        j_cost.target_ranks_from_env() == [2, 4, 16]
    for n in (2, 4, 8, 1024):
        for kinds in (["allreduce_async"] * 7, ["allreduce", "barrier"]):
            events = [types.SimpleNamespace(kind=k) for k in kinds]
            assert t_cost.predict_step(events, n, table,
                                       step_bytes=1 << 26) == \
                j_cost.predict_step(events, n, table, step_bytes=1 << 26)
        assert t_cost.bucket_optimum(1 << 28, n, table) == \
            j_cost.bucket_optimum(1 << 28, n, table)


@pytest.mark.parametrize("rel", ["bad_scale_cliff.py", "bad_bucket_knob.py",
                                 "good_perf_clean.py"])
def test_analyze_corpus_and_report_match_jax(rel):
    reports = []
    for pkg in (PORT, JAX):
        verifier = pkg.sim.Verifier()
        verifier.add_path(os.path.join(PERF_FIXTURES, rel))
        report = pkg.cost.analyze_corpus(
            verifier, table=pkg.cost.load_table(FIXTURE_TABLE),
            target_ranks=RANKS)
        reports.append((json.loads(json.dumps(report)),
                        pkg.cost.render_report(report)))
    assert reports[0] == reports[1]


def test_cli_perf_calibrate_and_table(tmp_path):
    paths = _write_shards(str(tmp_path))
    table = str(tmp_path / "model.json")
    proc = _run_cli("perf", "--calibrate", paths[1], "--write-table", table)
    assert proc.returncode == 0, proc.stderr
    assert "at world size(s) 4" in proc.stdout
    assert t_cost.load_table(table)["source"] == "calibrated"
    proc = _run_cli("perf", os.path.join(PERF_FIXTURES, "bad_scale_cliff.py"),
                    "--table", FIXTURE_TABLE, "--target-ranks", "4,16",
                    "--fail-on", "warning")
    assert proc.returncode == 1
    assert "predicted scaling" in proc.stdout and "HVD603" in proc.stdout
    garbage = tmp_path / "garbage.json"
    garbage.write_text("[1, 2]")
    assert _run_cli("perf", PROGRAM, "--table", str(garbage)).returncode == 2
    assert _run_cli("perf", "--calibrate",
                    str(tmp_path / "nothing")).returncode == 2


# -- the CLI, --self and the baseline ------------------------------------------

def _run_cli(*args, cwd=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.cli", *args],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=cwd or REPO)


def test_self_sweep_is_clean(tmp_path):
    # From outside the checkout: the baseline keys do not depend on cwd.
    proc = _run_cli("--self", cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
    assert "0 finding(s) (0 error(s), 0 warning(s), 6 baseline-" \
        "suppressed)" in proc.stdout


def test_self_baseline_holds_only_unported_knob_rows():
    from horovod_tpu.utils import envparse as jenv
    from horovod_tpu_torch.utils import envparse as tenv
    doc = t_base.load_baseline(t_cli.SELF_BASELINE)
    rows = doc["findings"].values()
    assert {r["rule"] for r in rows} == {"HVD306"}
    assert {r["file"] for r in rows} == {"docs/knobs.md"}
    named = {re.match(r"knob (\w+) is documented but not registered",
                      r["message"]).group(1) for r in rows}
    with open(os.path.join(REPO, "docs", "knobs.md")) as f:
        documented = {m.group(1) for m in map(
            t_ast._DOC_KNOB_RE.match, (ln.strip() for ln in f)) if m}
    # every documented knob the port does not register, and no other row
    assert named == documented - set(tenv.KNOBS)
    assert named <= set(jenv.KNOBS) | documented
    assert not named & set(tenv.KNOBS)


def test_cli_lint_verify_and_sarif_on_the_corpus():
    proc = _run_cli("verify", FIXTURES, "--format", "sarif", "--fail-on",
                    "never")
    assert proc.returncode == 0, proc.stderr
    run = json.loads(proc.stdout)["runs"][0]
    rules = [r["id"] for r in run["tool"]["driver"]["rules"]]
    for result in run["results"]:
        assert rules[result["ruleIndex"]] == result["ruleId"]
        if result["ruleId"] in ("HVD501", "HVD502"):
            assert len(result["codeFlows"][0]["threadFlows"]) >= 2
    proc = _run_cli(os.path.join(FIXTURES, "bad_rank_guard.py"))
    assert proc.returncode == 1 and "HVD201" in proc.stdout
    assert _run_cli(os.path.join(FIXTURES, "good_clean.py"),
                    "--fail-on", "warning").returncode == 0


def test_baseline_round_trip_and_root_keys(tmp_path, monkeypatch):
    bad = tmp_path / "train.py"
    bad.write_text("import horovod_tpu_torch as hvd\n"
                   "if hvd.rank() == 0:\n"
                   "    hvd.allreduce(1)\n")
    base = str(tmp_path / "b.json")
    assert _run_cli(str(bad), "--write-baseline", base).returncode == 0
    proc = _run_cli(str(bad), "--baseline", base)
    assert proc.returncode == 0 and "1 baseline-suppressed" in proc.stdout
    bad.write_text(bad.read_text() + "if hvd.rank() == 1:\n"
                   "    hvd.barrier()\n")
    assert _run_cli(str(bad), "--baseline", base).returncode == 1
    (tmp_path / "corrupt.json").write_text("{")
    assert _run_cli(str(bad), "--baseline",
                    str(tmp_path / "corrupt.json")).returncode == 2
    # keys relative to a root read the same from any working directory
    diags = t_ast.lint_paths([str(bad)])
    monkeypatch.chdir(tmp_path)
    here = t_base.finding_keys(diags, root=str(tmp_path))
    monkeypatch.chdir(REPO)
    assert t_base.finding_keys(diags, root=str(tmp_path)) == here
    assert here[0].startswith("HVD201:train.py:")


def test_knob_and_metric_docs_cross_checks():
    knobs = t_ast.check_knob_docs(os.path.join(REPO, "docs", "knobs.md"))
    assert {d.rule for d in knobs} == {"HVD306"}
    assert t_ast.check_metric_docs(
        os.path.join(REPO, "docs", "metrics.md")) == []
    pkg = os.path.join(REPO, "horovod_tpu_torch")
    assert t_ast._registered_metrics(
        [os.path.join(pkg, "serving", "metrics.py"),
         os.path.join(pkg, "fleet", "metrics.py")])


# -- Program.prove on the port's TwoDZero programs -----------------------------

def _twod(dp, tp):
    import functools as ft

    import torch

    import torch_port_sharding_worker as w
    from horovod_tpu_torch import resharding
    from horovod_tpu_torch.parallel import twod
    tz = twod.TwoDZero(ft.partial(torch.optim.Adam, lr=1e-2),
                       {"dp": dp, "tp": tp})
    params = w.twod_params()
    tz.ensure_plan(params)
    return tz, params, resharding


def test_twod_reshard_and_serve_programs_prove_clean():
    tz4, params, resharding = _twod(2, 2)
    tz2, _, _ = _twod(1, 2)
    meta = resharding.tree_meta_of(params)
    program = resharding.plan_redistribution(
        tz4.spec_2d(params), tz2.spec_2d(params), meta)
    assert program.bytes_moved() > 0
    assert program.prove() == [] == program.prove(8)
    src = resharding.Spec({"dp": 2, "tp": 2}, tz4.tensor_layouts())
    for world in (1, 2):
        dst = resharding.replicated_spec(len(meta), {"s": world})
        assert resharding.plan_redistribution(src, dst, meta).prove() == []


# -- the package surface --------------------------------------------------------

def test_import_loads_no_parser_and_enforce_raises():
    code = ("import sys, horovod_tpu_torch.analysis as a\n"
            "import horovod_tpu_torch.analysis.protocol\n"
            "heavy = [m for m in sys.modules if m.startswith("
            "'horovod_tpu_torch.analysis.') and m.split('.')[-1] in "
            "('ast_lint', 'schedule', 'simulate', 'costmodel', 'model')]\n"
            "print(heavy)\n"
            "a.lint_source\n"
            "print('horovod_tpu_torch.analysis.ast_lint' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
    from horovod_tpu_torch.exceptions import CollectiveLintError
    errs = t_analysis.lint_source("import horovod_tpu_torch as hvd\n"
                                  "if hvd.rank() == 0:\n"
                                  "    hvd.allreduce(1)\n")
    assert [d.rule for d in errs] == ["HVD201"]
    assert t_analysis.enforce(errs, False) == errs
    assert t_analysis.enforce(errs, "warn") == errs
    with pytest.raises(CollectiveLintError, match="HVD201"):
        t_analysis.enforce(errs, True)
    with pytest.raises(NotImplementedError, match="item 15"):
        t_analysis.verify_traceable(lambda: None, ())
    assert t_analysis.runtime_axis_sizes() == {}
