"""Pure transition spec of the fleet lease ledger (port of
``horovod_tpu/analysis/protocol/lease_spec.py``).

This module IS the lease state machine: ``fleet/ledger.py`` imports and
executes these functions. The chains, the validation and the resume rules
are the JAX package's, so a ledger written by either package's arbiter is
resumed the same way by the other's. The ``hvd-model`` checker
(``machines.py``) explores these same functions. Stdlib-pure — no
backend, no clock, no journal.
"""

TRAIN_TO_SERVE = "train_to_serve"
SERVE_TO_TRAIN = "serve_to_train"
DIRECTIONS = (TRAIN_TO_SERVE, SERVE_TO_TRAIN)

#: Per-direction state chains. ``rolled_back`` is reachable only from
#: ``proposed`` (nothing actuated yet); every later state rolls
#: forward — the transfer state machine in docs/fault_tolerance.md.
CHAINS = {
    TRAIN_TO_SERVE: ("proposed", "preempting", "resharding",
                     "activating", "complete"),
    SERVE_TO_TRAIN: ("proposed", "draining", "returning", "complete"),
}
TERMINAL_STATES = ("complete", "rolled_back")


class LeaseStateError(RuntimeError):
    """An illegal lease transition was attempted; the message names
    the lease, its state, and the requested state."""


def next_state(direction, state):
    """The successor of ``state`` on ``direction``'s chain (None at
    the end)."""
    chain = CHAINS[direction]
    idx = chain.index(state)
    return chain[idx + 1] if idx + 1 < len(chain) else None


def resume_action(lease):
    """What a freshly-promoted arbiter must do with a recovered
    in-flight lease: ``None`` (terminal — nothing), ``"rollback"``
    (``proposed`` — the ledger won the race, no actuation happened),
    or ``"roll_forward"`` (re-issue the current state's idempotent
    actuation and keep going)."""
    state = lease["state"]
    if state in TERMINAL_STATES:
        return None
    if state == "proposed":
        return "rollback"
    return "roll_forward"


def check_transition(lease, state):
    """Validate one requested transition against the chain invariants
    (raises :class:`LeaseStateError`): ``rolled_back`` only from
    ``proposed``; everything else must be the chain successor."""
    direction = lease["direction"]
    current = lease["state"]
    if state == "rolled_back":
        if current != "proposed":
            raise LeaseStateError(
                f"lease {lease['id']}: cannot roll back from "
                f"{current!r} — actuation may have started; roll "
                "forward instead")
        return
    chain = CHAINS[direction]
    if state not in chain:
        raise LeaseStateError(
            f"lease {lease['id']}: {state!r} is not a {direction} "
            f"state (chain: {' -> '.join(chain)})")
    if state != next_state(direction, current):
        raise LeaseStateError(
            f"lease {lease['id']}: illegal transition "
            f"{current!r} -> {state!r} (chain: {' -> '.join(chain)})")


__all__ = ["TRAIN_TO_SERVE", "SERVE_TO_TRAIN", "DIRECTIONS", "CHAINS",
           "TERMINAL_STATES", "LeaseStateError", "next_state",
           "resume_action", "check_transition"]
