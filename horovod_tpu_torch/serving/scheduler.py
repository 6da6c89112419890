"""Continuous-batching scheduler: prefill admission interleaved with
in-flight decode, the batch recomposed every step (port of
``horovod_tpu/serving/scheduler.py``).

Static batching pads every request to the slowest member and leaves the
accelerator idle in the gaps; continuous batching re-forms the running
batch at every decode step — finished sequences leave immediately, new
prompts prefill into the freed budget, and the decode batch is whatever
is alive *right now*. The scheduler owns that loop:

1. **resume** preempted sequences (LRU order) whose pages fit again —
   recompute-on-resume: the prompt *and* everything generated so far
   re-prefill into fresh pages, which is exact because a ModelAdapter's
   prefill is defined to reproduce the per-token KV appends;
2. **admit** new requests from the bounded queue while the per-step
   prefill token budget (``max_batch_tokens`` minus one slot per
   running sequence) holds and the page pool stays above its admission
   watermark — otherwise admission *blocks* (the request stays queued;
   ``admission_blocked`` counts every refusal so tests can prove the
   watermark engaged);
3. **decode** one token for every running sequence through its page
   table; KV growth that exhausts the pool preempts the
   least-recently-(re)admitted sequence and retries — with a Migrator
   wired (serving/migration.py) the victim is first offered to a peer
   as a verified page transfer, and only a refused/failed transfer
   falls back to the recompute preemption above;
4. **retire** finished sequences (max tokens or EOS), freeing pages and
   completing their streams.

Bounded end to end: the admission queue is a ``queue.Queue(maxsize=
queue_limit)`` — ``submit`` never buffers past it (rule HVD210 exists
to keep it that way) — and each sequence's token stream is bounded by
its own ``max_new_tokens``.

Threading: ``submit``/``stats`` are called from HTTP handler threads,
``step`` from the single worker loop thread; ``_lock`` guards the
shared tables. The scheduler never sleeps — pacing belongs to the
worker loop. ``step`` holds the lock to admit and to snapshot the batch
and its gathered contexts, releases it for ``model.decode``, and retakes
it to apply the tokens, skipping any sequence that a concurrent
migration moved meanwhile: ``stats()``, ``submit()``, drain and
migrations answer during a slow decode. ``import_remote`` never takes
the lock: a migrated-in sequence waits in an inbox until the tables are
next read, so two workers shedding to each other at once never wait on
each other's step. (The JAX scheduler holds the lock across the decode
and the import, ROADMAP queue C.)
"""

import collections
import itertools
import queue
import threading
import time

from . import metrics as _m
from .kv_cache import NoHeadroom, PagePool, PageTable, PoolExhausted

#: recent step compositions kept for stats/debug (bounded).
STEP_LOG = 256

QUEUED, PREFILL, RUNNING, PREEMPTED, DONE, FAILED, MIGRATED = (
    "queued", "prefill", "running", "preempted", "done", "failed",
    "migrated")


class Request:
    """One generation request as the scheduler sees it."""

    __slots__ = ("id", "prompt", "max_new_tokens")

    def __init__(self, id, prompt, max_new_tokens):
        self.id = str(id)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class SequenceResult:
    """Completion surface of one request: a bounded token stream (one
    slot per possible token + the terminal None) plus a done event and
    the final summary dict."""

    def __init__(self, max_new_tokens):
        self.stream = queue.Queue(maxsize=max_new_tokens + 1)
        self.done = threading.Event()
        self.summary = None

    def finish(self, summary):
        self.summary = summary
        try:
            self.stream.put_nowait(None)
        except queue.Full:  # stream already carries the terminal slot
            pass
        self.done.set()

    def tokens(self, timeout=None):
        """Block until completion; the full generated token list (or
        raises TimeoutError)."""
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        return list(self.summary["tokens"])


class _Seq:
    __slots__ = ("req", "result", "table", "generated", "state",
                 "t_submit", "t_admit", "t_prefill_done", "t_done",
                 "admit_stamp", "preempts", "migrations")

    def __init__(self, req, result):
        self.req = req
        self.result = result
        self.table = None
        self.generated = []
        self.state = QUEUED
        self.t_submit = time.monotonic()
        self.t_admit = None
        self.t_prefill_done = None
        self.t_done = None
        self.admit_stamp = 0     # LRU key: last (re)admission order
        self.preempts = 0
        self.migrations = 0      # hops this sequence arrived through

    def tokens_alive(self):
        return self.req.prompt + self.generated


class Scheduler:
    """One host's continuous-batching scheduler over a page pool."""

    def __init__(self, model, pool=None, *, max_batch_tokens=256,
                 queue_limit=64, num_pages=256, page_size=16,
                 watermark=None):
        self.model = model
        if pool is None:
            pool = PagePool(num_pages, page_size,
                            kv_dim=model.kv_dim, watermark=watermark,
                            device=getattr(model, "device", None))
        self.pool = pool
        self.max_batch_tokens = int(max_batch_tokens)
        self.queue_limit = int(queue_limit)
        # The one place requests wait: bounded, so a flood turns into
        # submit()=False -> 429 at the HTTP layer, never into memory.
        self._admit_q = queue.Queue(maxsize=self.queue_limit)
        self._lock = threading.Lock()
        self._running = {}            # id -> _Seq, decode set
        self._preempted = collections.OrderedDict()  # id -> _Seq, LRU
        # migrated-in sequences waiting to join the tables
        self._inbox_lock = threading.Lock()
        self._inbox = []
        self._stamp = itertools.count(1)
        self.step_log = collections.deque(maxlen=STEP_LOG)
        # End-to-end (submit -> done) latencies of recent completions,
        # bounded so stats() can report a rolling p99 without the
        # window itself becoming an unbounded buffer (HVD210).
        self._latency_window = collections.deque(maxlen=256)
        self.draining = False
        self.steps = 0
        self.completed = 0
        self.failed = 0
        self.admission_blocked = 0
        self.tokens_out = 0
        self.preemptions = 0
        # -- live migration (docs/serving.md) --------------------------
        # A Migrator (serving/migration.py) set by the worker once it
        # knows the KV member plane; None = pure recompute, the
        # pre-migration behavior.
        self.migrator = None
        self.elastic_version = "0"   # stamped into exported records
        self.migrated_out = 0
        self.migrated_in = 0
        self.migrate_failed = 0

    # -- intake (HTTP handler threads) -------------------------------------
    def submit(self, req):
        """Queue a request for admission. Returns the
        :class:`SequenceResult` or ``None`` when the bounded queue is
        full / the host is draining (caller answers 429/503)."""
        if self.draining:
            return None
        total = len(req.prompt) + req.max_new_tokens
        if self.pool.pages_needed(total) > self.pool.num_pages \
                - self.pool.watermark:
            res = SequenceResult(req.max_new_tokens)
            res.finish({"id": req.id, "tokens": [], "state": FAILED,
                        "reason": "too_large",
                        "error": "request exceeds KV pool capacity"})
            return res
        if len(req.prompt) > self.max_batch_tokens:
            # A prompt the per-step budget can never prefill would sit
            # at the queue head forever and head-of-line-block every
            # request behind it — reject loudly instead.
            res = SequenceResult(req.max_new_tokens)
            res.finish({"id": req.id, "tokens": [], "state": FAILED,
                        "reason": "too_large",
                        "error": "prompt exceeds the per-step batch "
                                 "budget (HVDTPU_SERVING_MAX_BATCH_"
                                 "TOKENS)"})
            return res
        seq = _Seq(req, SequenceResult(req.max_new_tokens))
        try:
            self._admit_q.put_nowait(seq)
        except queue.Full:
            return None
        _m.queue_depth().set(self._admit_q.qsize())
        return seq.result

    def drain(self):
        """Stop admitting; in-flight and already-queued sequences run
        to completion (docs/serving.md drain semantics)."""
        self.draining = True

    def idle(self):
        with self._lock:
            self._take_inbox()
            busy = self._running or self._preempted
        return not busy and self._admit_q.empty()

    # -- admission ---------------------------------------------------------
    def _try_place(self, seq, budget, force=False):
        """Prefill ``seq`` into fresh pages if the watermark and the
        prefill token budget allow. Returns tokens spent (0 = blocked).
        ``force`` waives the token budget (NOT the watermark) — used
        only to resume a preempted sequence into an otherwise-empty
        batch, where pool capacity is the real bound."""
        toks = seq.tokens_alive()
        if len(toks) > budget and not force:
            return 0
        if not self.pool.can_admit(len(toks)):
            self.admission_blocked += 1
            return 0
        table = PageTable(self.pool)
        try:
            table.append(self.model.prefill(toks))
        except PoolExhausted:      # raced below watermark: stay queued
            table.release()
            self.admission_blocked += 1
            return 0
        now = time.monotonic()
        if seq.t_admit is None:
            seq.t_admit = now
            _m.latency("queue").observe(now - seq.t_submit)
        seq.table = table
        seq.state = RUNNING
        seq.admit_stamp = next(self._stamp)
        seq.t_prefill_done = time.monotonic()
        _m.latency("prefill").observe(seq.t_prefill_done - now)
        self._running[seq.req.id] = seq
        return len(toks)

    def _admit(self):
        self._take_inbox()
        budget = self.max_batch_tokens - len(self._running)
        # Preempted sequences first, least-recently-admitted order:
        # they already consumed queue latency once and hold completed
        # work worth resuming before fresh prompts pile in.
        for sid in list(self._preempted):
            if budget <= 0:
                break
            seq = self._preempted[sid]
            spent = self._try_place(seq, budget)
            if not spent and not self._running:
                # Nothing else is running and the LRU head still does
                # not fit the step budget (its prompt+generated grew
                # past max_batch_tokens while it was running). One
                # oversized re-prefill step beats a permanent stall:
                # pool capacity (checked at submit) is the real bound.
                spent = self._try_place(seq, budget, force=True)
            if spent:
                del self._preempted[sid]
                budget -= spent
            else:
                break  # LRU head blocked: keep resume order FIFO
        while budget > 0:
            try:
                seq = self._admit_q.get_nowait()
            except queue.Empty:
                break
            spent = self._try_place(seq, budget)
            if spent:
                budget -= spent
            else:
                # Blocked at the watermark/budget: the queue is the
                # wait station — put it back at the front by using a
                # side slot (order preserved for everything behind it).
                self._requeue_front(seq)
                break
        _m.queue_depth().set(self._admit_q.qsize())

    def _requeue_front(self, seq):
        # queue.Queue has no push-front; splice via the internal deque
        # under its own mutex (documented CPython attribute).
        with self._admit_q.mutex:
            self._admit_q.queue.appendleft(seq)
            self._admit_q.unfinished_tasks += 1
            self._admit_q.not_empty.notify()

    # -- preemption --------------------------------------------------------
    def _preempt_lru(self, exclude_id):
        """Free the least-recently-(re)admitted running sequence's
        pages. Migration first when a Migrator is wired: the victim's
        verified KV pages move to a peer with headroom and its stream
        completes there with **zero recompute**; any migration failure
        falls back to the status-quo recompute-on-resume path. Returns
        True when a victim was found (pages freed either way)."""
        victims = [s for s in self._running.values()
                   if s.req.id != exclude_id]
        if not victims:
            return False
        victim = min(victims, key=lambda s: s.admit_stamp)
        if self._try_migrate_out(victim):
            return True
        victim.table.release()
        victim.table = None
        victim.state = PREEMPTED
        victim.preempts += 1
        del self._running[victim.req.id]
        self._preempted[victim.req.id] = victim
        self.preemptions += 1
        _m.preempted_total().inc()
        return True

    # -- live migration ----------------------------------------------------
    def _export_record(self, seq):
        """``seq`` as a migration wire record: KV pages in table order
        (hot) or none at all (a preempted sequence migrates cold and
        resumes by recompute on the target), plus the sequence
        metadata — prompt, generated tokens, next position
        (num_tokens) — and the elastic-version fence."""
        rec = {"v": 1, "id": seq.req.id,
               "prompt": list(seq.req.prompt),
               "generated": list(seq.generated),
               "max_new_tokens": seq.req.max_new_tokens,
               "preempts": seq.preempts,
               "migrations": seq.migrations + 1,
               "elastic_version": str(self.elastic_version)}
        if seq.table is not None:
            rec.update(self.pool.export_sequence(seq.table))
        else:
            rec.update({"num_tokens": 0,
                        "page_size": self.pool.page_size,
                        "kv_dim": self.pool.kv_dim, "pages": []})
        return rec

    def _try_migrate_out(self, seq):
        """Export + hand ``seq`` to a peer through the migrator. True
        when the sequence now lives elsewhere: pages freed, stream
        finished locally with state ``migrated`` and the handoff record
        the router (or the worker itself) follows. False = caller
        falls back to recompute; the migrator has already counted and
        logged why (graceful degradation, never silent)."""
        if self.migrator is None:
            return False
        handoff = self.migrator.migrate_seq(self._export_record(seq))
        if handoff is None:
            self.migrate_failed += 1
            return False
        if seq.table is not None:
            seq.table.release()
            seq.table = None
        self._running.pop(seq.req.id, None)
        self._preempted.pop(seq.req.id, None)
        seq.state = MIGRATED
        seq.t_done = time.monotonic()
        self.migrated_out += 1
        seq.result.finish({
            "id": seq.req.id, "tokens": list(seq.generated),
            "state": MIGRATED, "handoff": handoff,
            "preempts": seq.preempts,
            "migrations": seq.migrations + 1,
        })
        return True

    def migrate_all_out(self):
        """Drain the accelerator by moving every live sequence to a
        peer (worker drain / SIGTERM hand-off) — chip-return latency
        decouples from stream length. Sequences whose migration falls
        back stay local and finish through the normal decode/recompute
        path. Returns the number migrated."""
        if self.migrator is None:
            return 0
        moved = 0
        with self._lock:
            self._take_inbox()
            live = (list(self._running.values())
                    + list(self._preempted.values()))
            for seq in live:
                if self._try_migrate_out(seq):
                    moved += 1
        return moved

    def import_remote(self, record):
        """Place a migrated-in sequence; ``(local_id, SequenceResult)``.
        Hot records (pages present) resume decoding from the imported
        KV with no prefill; cold records re-enter through the normal
        recompute admission. Raises kv_cache.MigrationError subtypes —
        always before anything is placed, so a refusal leaves this
        scheduler untouched (all-or-nothing).

        The import takes the pool's lock and the inbox's, never the
        scheduler's: a peer whose loop thread migrates a victim here
        while holding its own scheduler lock never waits on this
        scheduler's step. (The JAX scheduler takes its lock here, so two
        workers that shed to each other at once each wait on the other
        until the transfer times out; ROADMAP queue C.) The sequence
        joins the tables at the next step, ``stats()``, ``idle()`` or
        ``migrate_all_out()``.

        What imports hold is bounded: a hot record holds pages the pool
        admitted (at most ``num_pages`` records), and a cold record is
        refused with :class:`~.kv_cache.NoHeadroom` once ``queue_limit``
        sequences wait for recompute admission, in the inbox and among the
        preempted together (the source then tries its next peer, as for a
        full pool)."""
        req = Request(f"{record['id']}~m{next(self._stamp)}",
                      record["prompt"], record["max_new_tokens"])
        generated = [int(t) for t in record.get("generated", ())]
        table = None
        if int(record.get("num_tokens", 0)):
            table = self.pool.import_sequence(record)
        seq = _Seq(req, SequenceResult(req.max_new_tokens))
        seq.generated = generated
        seq.preempts = int(record.get("preempts", 0))
        seq.migrations = int(record.get("migrations", 1))
        now = time.monotonic()
        seq.t_admit = now
        if table is not None:
            seq.table = table
            seq.state = RUNNING
            seq.t_prefill_done = now
            seq.admit_stamp = next(self._stamp)
        else:
            seq.state = PREEMPTED
        with self._inbox_lock:
            # len() of the preempted table without the scheduler's lock:
            # a step may change it meanwhile, which moves the bound by the
            # sequences that step admits or preempts, never past it.
            if table is None and len(self._preempted) + sum(
                    s.table is None for s in self._inbox) \
                    >= self.queue_limit:
                raise NoHeadroom(
                    f"{self.queue_limit} sequences already wait for "
                    "recompute admission")
            # Bounded (docstring): pages held, or the cold cap above.
            self._inbox.append(seq)  # hvd-lint: disable=HVD210
            self.migrated_in += 1
        _m.migrations_total("imported").inc()
        return req.id, seq.result

    def _take_inbox(self):
        """Move migrated-in sequences into the tables (caller holds
        ``_lock``)."""
        with self._inbox_lock:
            arrived, self._inbox = self._inbox, []
        for seq in arrived:
            if seq.table is not None:
                self._running[seq.req.id] = seq
            else:
                self._preempted[seq.req.id] = seq

    # -- completion --------------------------------------------------------
    def _finish(self, seq, state=DONE, error=None):
        if seq.table is not None:
            seq.table.release()
            seq.table = None
        seq.state = state
        seq.t_done = time.monotonic()
        if state == DONE:
            self.completed += 1
            self._latency_window.append(seq.t_done - seq.t_submit)
            if seq.t_prefill_done is not None:
                _m.latency("decode").observe(
                    seq.t_done - seq.t_prefill_done)
        else:
            self.failed += 1
        summary = {
            "id": seq.req.id, "tokens": list(seq.generated),
            "state": state, "preempts": seq.preempts,
            "migrations": seq.migrations,
            "latency": {
                "queue": (seq.t_admit or seq.t_done) - seq.t_submit,
                "prefill": ((seq.t_prefill_done - seq.t_admit)
                            if seq.t_prefill_done else 0.0),
                "decode": ((seq.t_done - seq.t_prefill_done)
                           if seq.t_prefill_done else 0.0),
            },
        }
        if error:
            summary["error"] = error
        seq.result.finish(summary)

    # -- the step ----------------------------------------------------------
    def step(self):
        """One continuous-batching step. Returns the step's batch
        composition (tuple of sequence ids) — empty when idle."""
        with self._lock:
            self._admit()
            batch = list(self._running.values())
            if not batch:
                # Idle ticks are not steps: logging them would wash the
                # recent-composition window out with () entries.
                return ()
            # The batch's contexts, gathered on the pool's one stream
            # before the lock is released: a page that a migration
            # frees during the decode is rewritten only after this
            # gather has read it.
            contexts = self.pool.gather_many([s.table for s in batch])
        next_tokens, next_kv = self.model.decode(contexts)
        with self._lock:
            for seq, tok, kv in zip(batch, next_tokens, next_kv):
                if seq.state in (MIGRATED, DONE, FAILED):
                    # Moved or finished while this step ran: a
                    # concurrent migrate_all_out during the decode, or
                    # an earlier sequence's exhaustion migrating this
                    # one away mid-step. Its exported KV (and token
                    # list) predate THIS step's token, so the target
                    # regenerates it deterministically as its first
                    # continuation step — recording it here too would
                    # double it.
                    continue
                seq.generated.append(int(tok))
                self.tokens_out += 1
                _m.tokens_total().inc()
                try:
                    seq.result.stream.put_nowait(int(tok))
                except queue.Full:
                    pass  # stream bound == max_new_tokens: can't happen
                done = (len(seq.generated) >= seq.req.max_new_tokens
                        or (self.model.eos_id is not None
                            and int(tok) == self.model.eos_id))
                if done:
                    if seq.req.id in self._running:
                        del self._running[seq.req.id]
                    else:
                        self._preempted.pop(seq.req.id, None)
                    self._finish(seq)
                    continue
                if seq.state == PREEMPTED:
                    # An earlier sequence's KV growth preempted this one
                    # mid-step. Its token for THIS step is already
                    # recorded (computed from the pre-preemption
                    # context); the resume prefill reconstructs the KV
                    # including it, so nothing is lost — just don't
                    # touch the released table.
                    continue
                # Grow the KV table by one token; exhaustion preempts
                # the LRU sequence and retries (recompute-on-resume).
                while True:
                    try:
                        seq.table.append(kv[None] if kv.ndim == 1
                                         else kv)
                        break
                    except PoolExhausted:
                        if not self._preempt_lru(seq.req.id):
                            del self._running[seq.req.id]
                            self._finish(
                                seq, state=FAILED,
                                error="KV pool exhausted with no "
                                      "preemption victim")
                            break
            self.steps += 1
            composition = tuple(sorted(s.req.id for s in batch))
            self.step_log.append(composition)
            return composition

    # -- stats -------------------------------------------------------------
    def stats(self):
        with self._lock:
            self._take_inbox()
            return {
                "queue_depth": self._admit_q.qsize(),
                "running": len(self._running),
                "preempted_waiting": len(self._preempted),
                "steps": self.steps,
                "completed": self.completed,
                "failed": self.failed,
                "tokens_out": self.tokens_out,
                "preemptions": self.preemptions,
                "admission_blocked": self.admission_blocked,
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "migrate_failed": self.migrate_failed,
                "pages_free": self.pool.free_pages,
                "pages_total": self.pool.num_pages,
                "draining": self.draining,
                "p99_latency": self._p99_locked(),
                "recent_steps": [list(c) for c in
                                 list(self.step_log)[-32:]],
            }

    def _p99_locked(self):
        """p99 of the recent end-to-end latency window (0.0 until the
        first completion). Holds self._lock via stats()."""
        if not self._latency_window:
            return 0.0
        ordered = sorted(self._latency_window)
        return ordered[min(len(ordered) - 1,
                           int(0.99 * len(ordered)))]
