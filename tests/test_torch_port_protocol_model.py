"""The port's ``hvd-model`` (``horovod_tpu_torch/analysis/protocol/``)
against the JAX package's, on the CPU.

Spec-is-implementation: the port's journal, fleet ledger, KV migration and
page pool execute the port's own spec functions (by identity, or through a
spy). Each protocol model, clean and with every seeded bug, explores the
same number of states and edges to the same depth in both packages and
reaches the same verdicts with the same minimized counterexamples; the
``hvd-model`` CLI gives the same exit codes and the same findings.
"""

import dataclasses
import json

import pytest

from horovod_tpu.analysis.protocol import cli as jcli, machines as jmach
from horovod_tpu.analysis.protocol import model as jmodel
from horovod_tpu_torch.analysis.protocol import (cli as tcli, journal_spec,
                                                 lease_spec, machines as tmach,
                                                 migration_spec)
from horovod_tpu_torch.analysis.protocol import model as tmodel
from horovod_tpu_torch.analysis.simulate import render_trace

CASES = [(p, None) for p in tmach.PROTOCOLS] + [
    (p, bug) for p in tmach.PROTOCOLS for bug in sorted(tmach.BUGS[p])]


# -- spec-is-implementation ---------------------------------------------------

def test_journal_delegates_to_the_port_spec():
    from horovod_tpu_torch.runner import journal
    assert journal.apply_entry is journal_spec.apply_entry
    assert journal.state_digest is journal_spec.state_digest
    assert journal.new_state is journal_spec.new_state
    assert journal.durable_key is journal_spec.durable_key
    assert journal.term_fences is journal_spec.term_fences
    assert journal.DURABLE_SCOPES is journal_spec.DURABLE_SCOPES
    assert journal.JournalError is journal_spec.JournalError


def test_fence_sites_use_the_spec_predicate():
    import inspect

    from horovod_tpu_torch.runner import elastic_driver, http_server
    assert "term_fences(" in inspect.getsource(
        http_server.KVStoreServer._check_write_term)
    assert "term_fences(" in inspect.getsource(
        http_server._KVStoreHandler._fence_term)
    assert "term_fences(" in inspect.getsource(elastic_driver)


def test_ledger_delegates_to_the_port_spec():
    from horovod_tpu_torch.fleet import ledger
    assert ledger.next_state is lease_spec.next_state
    assert ledger.resume_action is lease_spec.resume_action
    assert ledger.check_transition is lease_spec.check_transition
    assert ledger.CHAINS is lease_spec.CHAINS
    assert ledger.TERMINAL_STATES is lease_spec.TERMINAL_STATES
    assert ledger.LeaseStateError is lease_spec.LeaseStateError


def test_serving_migration_delegates_to_the_port_spec():
    from horovod_tpu_torch.serving import migration
    assert migration.chunk_pages is migration_spec.chunk_pages


def test_staging_offer_executes_the_spec_transition(monkeypatch):
    from horovod_tpu_torch.serving import migration
    calls = []
    real = migration_spec.stage_chunk

    def spy(entries, payload, **kw):
        calls.append(dict(kw))
        return real(entries, payload, **kw)

    monkeypatch.setattr(migration_spec, "stage_chunk", spy)
    staging = migration.InboundStaging(max_staged=2, ttl_s=5.0)
    record = staging.offer({
        "mid": "m", "chunk": 0, "total": 1,
        "pages": [{"payload": "x", "digest": "d"}],
        "meta": {"id": "s"}, "commit": True})
    assert calls and calls[0]["max_staged"] == 2
    assert calls[0]["ttl_s"] == 5.0
    assert record["id"] == "s"
    assert [p["digest"] for p in record["pages"]] == ["d"]


def test_staging_limit_maps_to_staging_full():
    from horovod_tpu_torch.serving import migration
    staging = migration.InboundStaging(max_staged=1, ttl_s=900.0)
    assert staging.offer({"mid": "a", "chunk": 0, "total": 2,
                          "pages": []}) is None
    with pytest.raises(migration.StagingFull):
        staging.offer({"mid": "b", "chunk": 0, "total": 2, "pages": []})


def test_pagepool_admission_is_the_spec_predicate(monkeypatch):
    from horovod_tpu_torch.serving import kv_cache
    seen = []

    def deny(free, need, watermark):
        seen.append((free, need, watermark))
        return False

    monkeypatch.setattr(kv_cache, "admits", deny)
    pool = kv_cache.PagePool(num_pages=8, page_size=4, device="cpu")
    assert pool.can_admit(4) is False
    with pytest.raises(kv_cache.NoHeadroom):
        pool.alloc_admit(1)
    assert seen and all(w == pool.watermark for _, _, w in seen)


# -- the explorer, protocol by protocol ----------------------------------------

def _summary(result):
    return {"states": result.states, "edges": result.edges,
            "depth": result.depth, "complete": result.complete,
            "ok": result.ok,
            "violations": [(v.kind, v.name, v.message,
                            [(s.label, s.fault) for s in v.trace])
                           for v in result.violations]}


def _diag_view(d):
    import os
    return (d.rule, d.severity, d.message, os.path.basename(d.file),
            bool(d.trace))


@pytest.mark.parametrize("protocol,bug", CASES,
                         ids=[f"{p}-{b or 'clean'}" for p, b in CASES])
def test_exploration_matches_jax(protocol, bug):
    tmodels = tmach.build(protocol, bug=bug)
    jmodels = jmach.build(protocol, bug=bug)
    assert [m.name for m in tmodels] == [m.name for m in jmodels]
    for tm, jm in zip(tmodels, jmodels):
        tres, jres = tmodel.explore(tm), jmodel.explore(jm)
        assert _summary(tres) == _summary(jres)
        assert tres.ok is (bug is None)
        tdiags = tmodel.result_diagnostics(tm, tres)
        jdiags = jmodel.result_diagnostics(jm, jres)
        assert [_diag_view(d) for d in tdiags] == \
            [_diag_view(d) for d in jdiags]
        for d in tdiags:
            # counterexamples anchor at the port's own spec functions
            assert "horovod_tpu_torch" in d.file
            assert render_trace(d)


def test_pinned_space_sizes_and_registry():
    want = {"ha": [36], "lease": [28, 22], "migration": [202]}
    for protocol, states in want.items():
        assert [tmodel.explore(m).states
                for m in tmach.build(protocol)] == states
    assert tmach.BUGS == jmach.BUGS
    assert tmach.PROTOCOLS == jmach.PROTOCOLS
    with pytest.raises(ValueError):
        tmach.build("nope")


def test_budget_overrun_matches_jax():
    tm, jm = tmach.build("migration")[0], jmach.build("migration")[0]
    tres = tmodel.explore(tm, max_states=5)
    jres = jmodel.explore(jm, max_states=5)
    assert _summary(tres) == _summary(jres)
    assert [d.rule for d in tmodel.result_diagnostics(tm, tres)] == \
        ["HVD703"]


# -- the CLI -------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--protocol", "all"],
    ["--protocol", "ha", "--seed-bug", "skip_fence"],
    ["--protocol", "migration", "--seed-bug", "double_import",
     "--format", "json"],
    ["--protocol", "lease", "--seed-bug", "actuate_before_ledger",
     "--format", "sarif"],
    ["--protocol", "migration", "--max-states", "5"],
    ["--seed-bug", "skip_fence"],
    ["--list"],
], ids=["clean", "text", "json", "sarif", "budget", "usage", "list"])
def test_cli_matches_jax(argv, capsys):
    trc = tcli.main(list(argv))
    tout = capsys.readouterr().out
    jrc = jcli.main(list(argv))
    jout = capsys.readouterr().out
    assert trc == jrc
    if "--format" in argv and argv[argv.index("--format") + 1] == "sarif":
        tdoc, jdoc = json.loads(tout), json.loads(jout)
        for doc in (tdoc, jdoc):
            doc["runs"][0]["tool"]["driver"].pop("version", None)
        tres, jres = tdoc["runs"][0]["results"], jdoc["runs"][0]["results"]
        assert [(r["ruleId"], r["message"]["text"]) for r in tres] == \
            [(r["ruleId"], r["message"]["text"]) for r in jres]
        assert all(r["codeFlows"][0]["threadFlows"] for r in tres)
        assert tdoc["runs"][0]["tool"]["driver"]["name"] == "hvd-model"
    elif "json" in argv:
        assert [(d["rule"], d["message"]) for d in json.loads(tout)] == \
            [(d["rule"], d["message"]) for d in json.loads(jout)]
    else:
        def norm(text):
            # wall times and the anchors' paths differ by package
            import re
            text = re.sub(r"in \d+\.\d+s", "in Xs", text)
            return re.sub(r"\S*/(\w+\.py):\d+", r"\1", text)
        assert norm(tout) == norm(jout)


def test_counterexample_replays_to_the_jax_states():
    (tm,), (jm,) = (tmach.build("ha", bug="skip_fence"),
                    jmach.build("ha", bug="skip_fence"))
    (v,) = tmodel.explore(tm).violations
    assert dataclasses.asdict(v)["name"] == "single_writer_per_term"
    labels = [s.label for s in v.trace]
    states = tmodel.replay(tm, labels)
    assert len(states) == len(labels) + 1
    assert states == jmodel.replay(jm, labels)
    assert tmodel.replay(tm, labels + ["nope"]) is None
