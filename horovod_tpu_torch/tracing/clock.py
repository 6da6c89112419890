"""Clock alignment: estimate this rank's offset to the launcher's clock
(port of ``horovod_tpu/tracing/clock.py``).

Cross-rank trace merging compares wall-clock stamps taken on different
hosts; tens of milliseconds of skew — common even under NTP — would
fabricate stragglers out of thin air (a 50 ms-fast clock makes every
submit look 50 ms late). The classic NTP-style exchange against the
launcher's KV server fixes the frame:

    t0 = local clock            # request leaves
    ts = GET /clock             # server stamps its wall clock
    t1 = local clock            # response arrives

Assuming symmetric network delay, the server stamped at the midpoint,
so ``offset = (t0 + t1) / 2 - ts`` (positive = this rank's clock runs
ahead of the driver's) with uncertainty bounded by the round trip.
Sampling a few times and keeping the **minimum-RTT** sample rejects
queueing noise the way NTP's clock filter does. Every shard records its
offset in the meta header; the merger subtracts it, putting all ranks
on the driver's clock. The residual error (± min-RTT/2) is recorded too
so the analyzer can refuse to call sub-RTT skews "stragglers".
"""

import time

DEFAULT_SAMPLES = 5
_SAMPLE_TIMEOUT_S = 2.0


def server_time(addr, port, token="", timeout=_SAMPLE_TIMEOUT_S):
    """The driver KV server's wall clock (``GET /clock``, token-gated
    like every other route). Raises on transport trouble or an old
    server without the route — callers degrade to offset 0."""
    from ..runner import http_client
    url = f"http://{addr}:{port}/clock"
    with http_client._request("GET", url, token=token,
                              timeout=timeout) as resp:
        return float(resp.read())


def estimate_offset(addr, port, token="", samples=DEFAULT_SAMPLES):
    """``(offset_s, rtt_s)`` of the minimum-RTT sample, or ``(0.0,
    None)`` when the server is unreachable / pre-/clock. ``offset_s``
    is local-minus-server: subtract it from local stamps to land on the
    driver's clock."""
    best = None
    for _ in range(max(1, samples)):
        t0 = time.time()
        try:
            ts = server_time(addr, port, token=token)
        except Exception:  # noqa: BLE001 — alignment is best-effort
            # A transport failure is not transient queueing noise: an
            # unreachable /clock (firewalled driver, pre-route server)
            # would fail all remaining samples too, each burning the
            # full timeout on init's critical path. One strike ends it.
            break
        t1 = time.time()
        rtt = t1 - t0
        offset = (t0 + t1) / 2.0 - ts
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    return best if best is not None else (0.0, None)
