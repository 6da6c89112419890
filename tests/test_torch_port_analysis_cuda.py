"""The port's offline analyzer against real runs on H100s, over NCCL (launcher
jobs of tests/torch_port_analysis_worker.py, one rank per GPU):

- **Calibration.** ``calib`` jobs at n = 2 and n = 4 with ``HVDTPU_TRACE=1``
  reduce the full-width flagship TransformerLM's gradient leaves (365M fp32
  values in 293 tensors) with ``allreduce_async``. ``costmodel.fit_shards``
  over both jobs' shards gives a calibrated α–β table for NCCL on the card
  (``worlds == [2, 4]``), and ``predict_step`` lands within 25% of each
  job's measured median step (the JAX package's bar,
  tests/test_costmodel.py::test_live_prediction_residual_within_tolerance).
- **hvd-lint perf on a trainer.** The calibrated table written out, ``perf
  --table`` of the worker script at ``--target-ranks 2,4`` predicts
  ``train_job``'s step; printed beside the ``train`` jobs' measured steps
  at n = 2 and n = 4 (reported, no bar).
- **explain on a card bundle.** A two-GPU ``diverge`` job (rank 1
  allgathers ``step3`` where rank 0 allreduces it) is refused by each
  rank's consistency check; ``explain`` of the postmortems names slot
  ``step3``, an HVD5xx diagnosis and the worker's two submitting lines.
  A two-GPU ``skip`` job (rank 1 skips ``skip3``) is aborted by each
  rank's stuck-collective watchdog; ``explain`` names HVD501 and the
  worker's allreduce line at the slot whose submission came first, which
  is ``skip3`` (rank 0's) or ``skip4`` (rank 1's): both ranks submit
  theirs as soon as ``skip2`` completes, so the order is a race that
  the JAX package's ``explain`` resolves alike on the same bundle
  (tests/test_torch_port_analysis.py). With ``ANALYSIS_KEEP_BUNDLES=DIR``
  both bundles are copied to ``DIR/<mode>``.
- **prove.** Every redistribution program that
  tests/test_torch_port_sharding_cuda.py executes at n = 4 (the flagship
  tree Replicated(4) -> ZeRO-1 flat(4) and back; ``TwoDZero`` (2, 2)'s
  ``to_serving`` at serving worlds 1, 2 and 4 and its ``reshard_2d`` to
  (1, 2)) proves clean at 4 symbolic ranks.

Needs 4 GPUs (2 for the explain case); skips elsewhere:

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_analysis_cuda.py
"""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_analysis_worker.py")
RESIDUAL_BAR = 0.25
WORLDS = (2, 4)
JOB_TIMEOUT = 900


def _need(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (a multi-GPU machine)")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _job(mode, n, out, extra=()):
    """``mode`` of the worker as a launcher job of ``n`` ranks in ``out``;
    the ranks' results."""
    from test_torch_port_guardian import _env
    out.mkdir(parents=True, exist_ok=True)
    env = _env(dict(extra))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         str(n), "--start-timeout", "300", sys.executable, WORKER, mode,
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=JOB_TIMEOUT)
    res = {}
    for r in range(n):
        path = out / f"r{r}.json"
        res[r] = json.loads(path.read_text()) if path.exists() else None
    assert all(res.values()), \
        f"{mode} n={n} rc={proc.returncode}:\n" + \
        (proc.stdout + proc.stderr)[-6000:]
    return res


@pytest.fixture(scope="module")
def built():
    _need(2)
    import torch_port_launch
    torch_port_launch.build_port_core()
    return _card()


@pytest.fixture(scope="module")
def runs(built, tmp_path_factory):
    """The ``calib`` jobs at n = 2 and 4 and the table fitted to them."""
    _need(max(WORLDS))
    root = tmp_path_factory.mktemp("analysis-card")
    calib = {}
    for n in WORLDS:
        res = _job("calib", n, root / f"calib{n}",
                   {"HVDTPU_TRACE": "1",
                    "HVDTPU_TRACE_DIR": str(root / f"calib{n}" / "traces")})
        calib[n] = res[0]
        print(f"[analysis card] {built}: n={n} calib step "
              f"{calib[n]['step_s'] * 1e3:.3f} ms ({calib[n]['leaves']} "
              f"leaves, {calib[n]['step_bytes']} B)", flush=True)
    assert {c["backend"] for c in calib.values()} == {"nccl-global"}
    from horovod_tpu_torch.analysis import costmodel
    from horovod_tpu_torch.tracing import merge
    shards = merge.load_paths(
        [str(root / f"calib{n}" / "traces") for n in WORLDS],
        kinds=(merge.SHARD_PREFIX,))
    from horovod_tpu_torch.tracing import analyze
    for n in WORLDS:
        steps = [st for st in analyze.analyze(
            [sh for sh in shards if sh["meta"].get("size") == n])["steps"]
            if st.get("duration_s")]
        walls = sorted(st["duration_s"] for st in steps)
        spans = sorted(
            sp["fin"] - sp["sub"] for sh in shards
            if sh["meta"].get("size") == n and sh["meta"].get("rank") == 0
            for sp in merge.collective_spans(sh).values()
            if sp["sub"] is not None and sp["fin"] is not None)
        print(f"[analysis card] {built}: n={n} traced steps "
              f"{len(walls)}, median first sub -> last fin "
              f"{walls[len(walls) // 2] * 1e3:.3f} ms; rank 0's spans "
              f"{len(spans)}, median {spans[len(spans) // 2] * 1e3:.3f} "
              f"ms, max {spans[-1] * 1e3:.3f} ms", flush=True)
    table = costmodel.fit_shards(shards)
    path = root / "nccl_table.json"
    costmodel.save_table(table, str(path))
    kinds = {k: v for k, v in table["kinds"].items()
             if k in {costmodel.canonical_kind(s.get("kind"))
                      for sh in shards
                      for s in merge.collective_spans(sh).values()}}
    print(f"[analysis card] {built}: calibrated table over "
          f"{table['spans']} spans, worlds {table['worlds']}: kinds {kinds}, "
          f"compute_s {table['compute_s']}, fixed_s {table['fixed_s']}, "
          f"serial_fraction {table['serial_fraction']}, step_bytes "
          f"{table['step_bytes']}", flush=True)
    return {"calib": calib, "table": table, "table_path": str(path),
            "card": built}


@pytest.fixture(scope="module")
def train_runs(runs, tmp_path_factory):
    """The ``train`` jobs at n = 2 and 4 (the flash kernels built)."""
    from horovod_tpu_torch import _build
    _build.build(["flash_attention"])
    root = tmp_path_factory.mktemp("analysis-train")
    train = {}
    for n in WORLDS:
        train[n] = _job("train", n, root / f"train{n}")[0]
        print(f"[analysis card] {runs['card']}: n={n} train step "
              f"{train[n]['step_s'] * 1e3:.3f} ms, losses "
              f"{[round(x, 4) for x in train[n]['losses'][:3]]}",
              flush=True)
    return train


def test_nccl_calibration_predicts_each_step_within_the_bar(runs):
    from horovod_tpu_torch.analysis import costmodel
    table = runs["table"]
    assert table["source"] == "calibrated"
    assert table["worlds"] == list(WORLDS)
    misses = []
    for n, row in runs["calib"].items():
        events = [types.SimpleNamespace(kind="allreduce_async")
                  ] * row["leaves"]
        pred = costmodel.predict_step(events, n, table,
                                      step_bytes=row["step_bytes"])
        residual = abs(pred["step_s"] - row["step_s"]) / row["step_s"]
        print(f"[analysis card] {runs['card']}: n={n} predicted "
              f"{pred['step_s'] * 1e3:.3f} ms, measured "
              f"{row['step_s'] * 1e3:.3f} ms, residual {residual:.1%}",
              flush=True)
        if residual > RESIDUAL_BAR:
            misses.append(f"n={n}: predicted {pred['step_s'] * 1e3:.3f} ms "
                          f"vs measured {row['step_s'] * 1e3:.3f} ms "
                          f"(residual {residual:.1%})")
    assert not misses, "; ".join(misses)


def test_hvd_lint_perf_predicts_the_trainer(runs, train_runs):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.cli", "perf",
         WORKER, "--table", runs["table_path"], "--target-ranks", "2,4",
         "--fail-on", "never"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    print("[analysis card] " + proc.stdout.replace(
        "\n", "\n[analysis card] "), flush=True)
    from horovod_tpu_torch.analysis import costmodel, schedule
    verifier = schedule.Verifier()
    verifier.add_path(WORKER)
    report = costmodel.analyze_corpus(verifier, table=runs["table"],
                                      target_ranks=list(WORLDS))
    (row,) = [r for r in report["functions"]
              if r["function"].endswith("train_job")]
    for n in WORLDS:
        pred = row["curve"][n]["step_s"]
        meas = train_runs[n]["step_s"]
        print(f"[analysis card] {runs['card']}: train_job n={n}: "
              f"hvd-lint perf predicts {pred * 1e3:.3f} ms, measured "
              f"{meas * 1e3:.3f} ms (ratio {pred / meas:.3f})", flush=True)
        assert pred > 0 and meas > 0


def _step_lines(prefix="step"):
    with open(WORKER) as f:
        return {i for i, line in enumerate(f, start=1)
                if f'name=f"{prefix}{{epoch}}"' in line}


def _explain(traces, mode, card):
    """``hvd-lint explain`` of ``traces`` against the worker: the JSON
    report, after printing the text one (and keeping the bundle when
    ``ANALYSIS_KEEP_BUNDLES`` is set)."""
    keep = os.environ.get("ANALYSIS_KEEP_BUNDLES")
    if keep:
        shutil.copytree(traces, os.path.join(keep, mode),
                        dirs_exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.cli", "explain",
         str(traces), "--program", WORKER, "--format", "json"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    text = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.cli", "explain",
         str(traces), "--program", WORKER], cwd=REPO, capture_output=True,
        text=True, timeout=300).stdout
    print(f"[analysis card] {card}: explain of the {mode} bundle:\n"
          + text, flush=True)
    return json.loads(proc.stdout)


def test_explain_names_the_divergent_line_of_a_card_bundle(
        built, tmp_path):
    _need(2)
    traces = tmp_path / "traces"
    res = _job("diverge", 2, tmp_path / "job",
               {"HVDTPU_CONSISTENCY_CHECK": "1",
                "HVDTPU_TRACE_DIR": str(traces)})
    assert res[0]["done"] == [0, 1, 2] and res[1]["done"] == [0, 1, 2], res
    assert all("CollectiveMismatchError" in r["error"]
               for r in res.values()), res
    report = _explain(traces, "diverge", built)
    div = report["divergence"]
    assert report["ranks"] == [0, 1]
    assert report["reason"] == "collective_mismatch"
    assert div["name"] == "step3"
    assert re.fullmatch(r"HVD5\d\d", div["rule"])
    assert div["kinds"] == ["allgather", "allreduce"]
    assert div["submitted_by"] == [0, 1]
    lines = {(os.path.basename(s["file"]), s["line"])
             for s in div["sources"]}
    assert lines == {("torch_port_analysis_worker.py", n)
                     for n in _step_lines()}


def test_explain_names_the_skipped_slot_of_a_card_bundle(built, tmp_path):
    _need(2)
    traces = tmp_path / "traces"
    res = _job("skip", 2, tmp_path / "job",
               {"HVDTPU_COLLECTIVE_TIMEOUT": "10",
                "HVDTPU_TRACE_DIR": str(traces)})
    for rank, r in res.items():
        print(f"[analysis card] {built}: skip job rank {rank}: done "
              f"{r['done']}, raised {r['error']!r}", flush=True)
    report = _explain(traces, "skip", built)
    # each rank stopped in its own slot after skip2 and raised
    assert res[0]["done"] == [0, 1, 2] and res[1]["done"] == [0, 1, 2], res
    assert all(r["error"] for r in res.values()), res
    div = report["divergence"]
    assert report["ranks"] == [0, 1]
    assert report["reason"] == "collective_abort"
    assert (div["type"], div["rule"]) == ("missing_submission", "HVD501")
    # the first submission of the two divergent slots names the slot
    assert (div["name"], tuple(div["submitted_by"])) in {
        ("skip3", (0,)), ("skip4", (1,))}, div
    lines = {(os.path.basename(s["file"]), s["line"])
             for s in div["sources"]}
    assert lines == {("torch_port_analysis_worker.py", n)
                     for n in _step_lines("skip")}


def _programs(n):
    """``(label, program)`` for each redistribution program the four-GPU
    sharding test executes, built from shapes alone."""
    import functools

    import chip_smoke as cs
    from horovod_tpu_torch import models, resharding
    from horovod_tpu_torch.ops import zero
    from horovod_tpu_torch.parallel import twod
    from horovod_tpu_torch.serving.state import serving_spec
    cfg = models.TransformerConfig(**cs.PAR_LM, causal=True, use_rope=True,
                                   attention_impl="flash")
    leaves = list(models.TransformerLM(cfg, device="meta").parameters())
    meta = resharding.tree_meta_of(leaves)
    rep = resharding.replicated_spec(len(leaves), {"src": n})
    flat = resharding.zero_flat_spec(zero.plan_zero(leaves, n), axis="hvd")
    out = [("flagship Replicated(4) -> ZeroFlat(4)",
            resharding.plan_redistribution(rep, flat, meta)),
           ("flagship ZeroFlat(4) -> Replicated(4)",
            resharding.plan_redistribution(flat, rep, meta))]
    glob, _ = cs.twod_inputs(torch.device("cpu"))
    inner = functools.partial(torch.optim.Adam, lr=1e-2)
    tz4 = twod.TwoDZero(inner, {"dp": 2, "tp": 2})
    tz2 = twod.TwoDZero(inner, {"dp": 1, "tp": 2})
    tz4.ensure_plan(glob)
    tz2.ensure_plan(glob)
    tmeta = resharding.tree_meta_of(glob)
    src = resharding.Spec({"dp": 2, "tp": 2}, tz4.tensor_layouts())
    for world, layout in ((1, "replicated"), (2, "rows"), (4, "rows")):
        out.append((f"TwoDZero(2, 2).to_serving({world}, {layout})",
                    resharding.plan_redistribution(
                        src, serving_spec(len(tmeta), world, layout),
                        tmeta)))
    out.append(("reshard_2d (2, 2) -> (1, 2)",
                resharding.plan_redistribution(
                    tz4.spec_2d(glob), tz2.spec_2d(glob), tmeta)))
    return out


def test_the_four_gpu_sharding_programs_prove_clean(built):
    for label, program in _programs(4):
        found = program.prove(4)
        print(f"[analysis card] prove {label}: {len(program.steps)} steps, "
              f"{program.strategy}, {len(found)} finding(s)", flush=True)
        assert found == [], [d.format() for d in found]
