"""Pure transition spec of KV-cache live migration (port of
``horovod_tpu/analysis/protocol/migration_spec.py``; serving/migration.py +
the admission fence in serving/kv_cache.py).

This module IS the migration handshake's state machine:
``serving/migration.py`` chunk-packs and reassembles through these
functions and ``kv_cache.PagePool`` admission-checks through
:func:`admits` (spec-is-implementation; the JAX package's ``hvd-model``
checker, ROADMAP item 15 for the port, replays the same functions under
injected chunk loss, duplication, reorder, and restarts). Stdlib-pure —
no sockets, no locks, no clock: time enters only as the explicit ``now``
argument.
"""


class StagingLimit(RuntimeError):
    """Inbound staging is at its concurrent-transfer bound; the wire
    layer (serving/migration.py ``StagingFull``) maps this to a 429."""


def chunk_pages(pages, max_bytes):
    """Greedily pack page entries into chunks whose encoded payload
    stays under ``max_bytes`` (at least one page per chunk — a single
    page past the bound still ships and the target's 413 makes the
    overflow loud). Always returns >= 1 chunk so a pageless (cold)
    record still carries its commit metadata."""
    max_bytes = int(max_bytes)
    chunks, cur, size = [], [], 0
    for pg in pages:
        sz = len(pg.get("payload", "")) + 128   # +json framing slack
        if cur and size + sz > max_bytes:
            chunks.append(cur)
            cur, size = [], 0
        cur.append(pg)
        size += sz
    chunks.append(cur)
    return chunks


def stage_chunk(entries, payload, *, max_staged, ttl_s, now):
    """Stage one inbound chunk against the reassembly state
    ``entries`` (``mid -> {chunks, total, meta, t}``), returning the
    assembled record when the migration is complete, else None.

    This is the one transition of the target's staging machine —
    ``InboundStaging.offer`` executes it under its lock with the real
    clock; the model checker executes it with a frozen one. Mutates
    ``entries`` in place: stale entries past ``ttl_s`` are swept, a
    completed transfer's entry is deleted *before* the record is
    handed to the importer (the dedup that makes a duplicated chunk
    of a finished migration reassemble nothing — the ``double_import``
    seeded bug removes exactly this line). Raises ValueError on a
    malformed chunk and :class:`StagingLimit` at the bound."""
    mid = str(payload["mid"])
    chunk = int(payload["chunk"])
    total = int(payload["total"])
    if total < 1 or not 0 <= chunk < total:
        raise ValueError(f"chunk {chunk} outside total {total}")
    for stale in [m for m, e in entries.items()
                  if now - e["t"] > ttl_s]:
        del entries[stale]
    entry = entries.get(mid)
    if entry is None:
        if len(entries) >= max_staged:
            raise StagingLimit(
                f"{len(entries)} inbound migrations already staged")
        entry = {"chunks": {}, "total": total, "meta": None, "t": now}
        entries[mid] = entry
    entry["t"] = now
    entry["chunks"][chunk] = list(payload.get("pages", []))
    if payload.get("meta") is not None:
        entry["meta"] = dict(payload["meta"])
    if (entry["meta"] is None
            or len(entry["chunks"]) < entry["total"]):
        return None
    del entries[mid]
    record = dict(entry["meta"])
    record["pages"] = [pg for i in sorted(entry["chunks"])
                       for pg in entry["chunks"][i]]
    return record


def admits(free, need, watermark):
    """The watermark admission predicate: may ``need`` pages be
    allocated out of ``free`` while keeping the reserve intact? One
    predicate for prefill admission, import placement
    (kv_cache.alloc_admit), and the model checker's invariant — the
    reserve is what lets running sequences keep growing during decode
    instead of deadlocking against arrivals."""
    return int(free) - int(need) >= int(watermark)


#: Source-side classification of a target's deterministic refusal:
#: outcome label -> (metric outcome, try the next peer?). Structural
#: refusals (the peer is full/draining) are worth another peer;
#: payload/version refusals mean the record itself cannot land and the
#: source falls back to recompute immediately.
REFUSAL_POLICY = {
    "no_headroom": ("no_headroom", True),
    "draining": ("no_headroom", True),
    "version_fenced": ("version_fence", False),
    "digest_mismatch": ("digest_mismatch", False),
    "geometry_mismatch": ("digest_mismatch", False),
    "too_large": ("refused", False),
}


def classify_refusal(outcome):
    """``(metric_outcome, try_next_peer)`` for one refusal outcome
    label (unknown labels count as a terminal ``refused``)."""
    return REFUSAL_POLICY.get(str(outcome), ("refused", False))


__all__ = ["StagingLimit", "chunk_pages", "stage_chunk", "admits",
           "REFUSAL_POLICY", "classify_refusal"]
