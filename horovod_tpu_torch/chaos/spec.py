"""Chaos spec grammar: ``HVDTPU_CHAOS`` → a list of injection rules (port
of ``horovod_tpu/chaos/spec.py``; the catalog below is the JAX package's,
word for word, so ``python -m horovod_tpu_torch.chaos.cli points`` lists
the same points).

A spec is a ``;``-separated list of rules, each
``point:action[:param]*``:

    kv_get:fail:n=3
    kv_put:delay:ms=500
    worker:hang:rank=1
    worker:preempt:rank=2:after_commits=3
    collective:fail:name=grad_*:once

Params are ``key=value`` pairs (plus the bare ``once`` flag, shorthand
for ``n=1``). A param segment without ``=`` that is not a known flag is
re-joined to the previous value with the ``:`` restored, so worker ids
keep their natural spelling: ``worker:hang:wid=localhost:1``.

Matchers (``rank``, ``wid``, ``name``, ``kind``, ``scope``, ``key``,
``after_commits``) select WHEN a rule applies; budget params (``n``,
``after``, ``p``+``seed``, ``marker``) bound HOW OFTEN it fires; effect
params (``ms``, ``code``, ``err``) shape WHAT it does. Parsing is
strict — an unknown point, action, or param raises ``ChaosSpecError``
naming the offending rule, because a silently ignored chaos rule would
make a "passing" chaos test meaningless.
"""


class ChaosSpecError(ValueError):
    """HVDTPU_CHAOS could not be parsed; the message names the rule."""


# point -> where it is threaded (the `hvd-chaos points` catalog).
POINTS = {
    "kv_get": "runner/http_client.py — every GET attempt (per retry)",
    "kv_put": "runner/http_client.py — every PUT attempt (per retry)",
    "kv_delete": "runner/http_client.py — every DELETE attempt (per retry)",
    "kv_wait": "runner/http_client.py — each wait_for_kv poll iteration",
    "collective": "coordinator.py submit() — framework-thread collective "
                  "submissions (matchers: name, kind)",
    "backend_submit": "backend/tcp_backend.py submit_entry() — "
                      "native-plane submissions (matchers: name, kind)",
    "worker": "elastic.py State.commit() — commit boundaries "
              "(matchers: rank, wid, after_commits)",
    "heartbeat": "runner/heartbeat.py — each worker heartbeat beat",
    "checkpoint": "checkpoint.py save() — after the checkpoint file "
                  "lands (matchers: name = final file basename)",
    "driver": "runner/elastic_driver.py main loop + runner/standby.py "
              "poll loop — driver-process faults (actions: kill = "
              "SIGKILL the driver, partition = black-hole its KV/"
              "journal routes for ms=N; matcher wid=primary|standby "
              "selects the role; docs/fault_tolerance.md Control-plane "
              "HA)",
    "transfer": "fleet/arbiter.py — each lease-transfer state "
                "transition, fired after the ledger write and before "
                "the actuation it authorises (matchers: name = target "
                "state, kind = direction train_to_serve|"
                "serve_to_train; docs/fault_tolerance.md Fleet "
                "arbitration)",
    "drain": "fleet/actuators.py — raising the serving drain flag "
             "during a serve->train ebb (matcher: name = cohort)",
    "migrate_out": "serving/migration.py migrate_out() — each chunk "
                   "POST attempt of a KV-cache live migration, per "
                   "retry (matchers: key = request id, name = "
                   "migration id; fail raises a retryable transport "
                   "error, corrupt flips payload bytes AFTER the "
                   "digest was computed so the target must refuse)",
    "migrate_in": "serving/worker.py handle_migrate_in() — each "
                  "received migrate chunk (matchers: key = migration "
                  "id, name = cohort.wid; fail answers a retryable "
                  "503, corrupt flips received payload bytes before "
                  "digest verification)",
}

# action -> what firing does.
ACTIONS = {
    "fail": "raise a point-appropriate error (kv/heartbeat: retryable "
            "transport error, shaped by err=reset|refused|timeout; "
            "collective/backend_submit: HorovodInternalError; otherwise "
            "ChaosInjectedError)",
    "delay": "sleep ms=N milliseconds (default 100) before proceeding",
    "hang": "SIGSTOP the whole process — a truly hung worker (all "
            "threads, heartbeats included)",
    "preempt": "SIGTERM self — a simulated cloud preemption notice",
    "exit": "os._exit(code=N, default 17) — an abrupt crash",
    "mismatch": "corrupt the consistency digest this rank publishes for "
                "the matched collective (guardian.py detects and names "
                "this rank); needs HVDTPU_CONSISTENCY_CHECK",
    "stall": "swallow the matched submission — this rank never submits "
             "the op, peers stall on it (stuck-collective watchdog "
             "territory)",
    "corrupt": "flip bytes inside the just-written checkpoint payload "
               "so its checksum fails on restore; at the migrate "
               "points, flip KV page payload bytes so the sha256 "
               "digest check refuses the transfer",
    "kill": "SIGKILL the whole process — an abrupt driver-host death "
            "(no cleanup, no journal flush beyond what already "
            "fsync'd; the warm-standby takeover scenario)",
    "partition": "driver only: the KV store stops answering (requests "
                 "dropped without a response) for ms=N (default "
                 "5000) — a symmetric control-plane network partition",
}

# Signal actions are consumed by the injection site itself (the site
# catches chaos.ChaosSignal and applies the effect in its own terms),
# so they are only legal at points whose call sites understand them —
# anywhere else the signal would escape as a crash.
SIGNAL_ACTION_POINTS = {
    "mismatch": ("collective",),
    "stall": ("collective", "backend_submit"),
    "corrupt": ("checkpoint", "migrate_out", "migrate_in"),
    "partition": ("driver",),
}

_FLAGS = {"once"}
_INT_KEYS = {"n", "after", "after_commits", "ms", "code", "seed", "rank"}
_FLOAT_KEYS = {"p"}
_STR_KEYS = {"name", "kind", "scope", "key", "wid", "marker", "err"}
_ALL_KEYS = _INT_KEYS | _FLOAT_KEYS | _STR_KEYS
_ERR_KINDS = ("reset", "refused", "timeout")


class Rule:
    """One parsed injection rule. Attribute per known param; unset
    params are None (``after`` defaults to 0: fire from the first
    match)."""

    __slots__ = ("point", "action", "source", "n", "after",
                 "after_commits", "ms", "code", "seed", "rank", "p",
                 "name", "kind", "scope", "key", "wid", "marker", "err")

    def __init__(self, point, action, params, source):
        self.point = point
        self.action = action
        self.source = source
        for k in _ALL_KEYS:
            setattr(self, k, params.get(k))
        if self.after is None:
            self.after = 0

    def __repr__(self):
        return f"Rule({self.source!r})"

    def describe(self):
        parts = [f"{self.point}:{self.action}"]
        for k in sorted(_ALL_KEYS):
            v = getattr(self, k)
            if v is not None and not (k == "after" and v == 0):
                parts.append(f"{k}={v}")
        return "  ".join(parts)


def _join_value_segments(segments):
    """Re-join ``:``-split value fragments: a segment without ``=`` that
    is not a flag belongs to the previous param's value (worker ids are
    ``host:slot``)."""
    out = []
    for seg in segments:
        if "=" in seg or seg in _FLAGS or not out:
            out.append(seg)
        else:
            out[-1] += ":" + seg
    return out


def _parse_rule(text):
    parts = text.split(":")
    if len(parts) < 2:
        raise ChaosSpecError(
            f"chaos rule {text!r}: expected point:action[:param]*")
    point, action = parts[0].strip(), parts[1].strip()
    if point not in POINTS:
        raise ChaosSpecError(
            f"chaos rule {text!r}: unknown injection point {point!r} "
            f"(known: {', '.join(sorted(POINTS))})")
    if action not in ACTIONS:
        raise ChaosSpecError(
            f"chaos rule {text!r}: unknown action {action!r} "
            f"(known: {', '.join(sorted(ACTIONS))})")
    params = {}
    once = False
    for seg in _join_value_segments([p.strip() for p in parts[2:]]):
        if seg in _FLAGS:
            once = True
            continue
        key, _, value = seg.partition("=")
        if key not in _ALL_KEYS:
            raise ChaosSpecError(
                f"chaos rule {text!r}: unknown param {key!r} "
                f"(known: {', '.join(sorted(_ALL_KEYS | _FLAGS))})")
        if key in _INT_KEYS:
            try:
                params[key] = int(value)
            except ValueError:
                raise ChaosSpecError(
                    f"chaos rule {text!r}: param {key}={value!r} is not "
                    f"an integer")
        elif key in _FLOAT_KEYS:
            try:
                params[key] = float(value)
            except ValueError:
                raise ChaosSpecError(
                    f"chaos rule {text!r}: param {key}={value!r} is not "
                    f"a number")
        else:
            params[key] = value
    if once:
        if "n" in params:
            # One of them would silently win — exactly the "rule not
            # doing what the spec says" hazard strict parsing exists
            # to prevent.
            raise ChaosSpecError(
                f"chaos rule {text!r}: 'once' and 'n=' are mutually "
                f"exclusive")
        params["n"] = 1
    if "p" in params and not 0.0 < params["p"] <= 1.0:
        raise ChaosSpecError(
            f"chaos rule {text!r}: p must be in (0, 1]")
    if params.get("err") is not None and params["err"] not in _ERR_KINDS:
        raise ChaosSpecError(
            f"chaos rule {text!r}: err must be one of "
            f"{', '.join(_ERR_KINDS)}")
    allowed = SIGNAL_ACTION_POINTS.get(action)
    if allowed is not None and point not in allowed:
        raise ChaosSpecError(
            f"chaos rule {text!r}: action {action!r} is only valid at "
            f"point(s) {', '.join(allowed)} (its effect is applied by "
            f"those call sites)")
    return Rule(point, action, params, text)


def parse_spec(text):
    """Parse a full ``HVDTPU_CHAOS`` value into [Rule]."""
    rules = []
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if chunk:
            rules.append(_parse_rule(chunk))
    return rules
