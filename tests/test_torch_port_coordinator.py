"""The port's Coordinator against the JAX package's, single process, on
recording backends: the same entries (shapes, dtypes, ops and scales drawn
from a seed with numpy) reach the backend in the same fusion buckets;
duplicate names raise ``DuplicateNameError`` in both; a name is free again
once its handle was waited for; ``stop()`` fails the entries still queued
with ``HorovodInternalError``; call-site auto names agree; the Python
timeline is valid Chrome-trace JSON with the JAX package's event layout.

Each case first submits a barrier that its backend holds until every entry
of the case is queued, so that one cycle drains them all: the buckets do
not depend on the thread's timing.
"""

import json
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu.coordinator as jcoord
import horovod_tpu.ops.collectives as jcoll
from horovod_tpu.exceptions import DuplicateNameError as JDuplicate
from horovod_tpu.exceptions import HorovodInternalError as JInternal
from horovod_tpu.timeline import Timeline as JTimeline

import horovod_tpu_torch.coordinator as tcoord
import horovod_tpu_torch.ops.collectives as tcoll
from horovod_tpu_torch.exceptions import DuplicateNameError as TDuplicate
from horovod_tpu_torch.exceptions import HorovodInternalError as TInternal
from horovod_tpu_torch.ops import reduce_ops
from horovod_tpu_torch.timeline import Timeline as TTimeline

class _Recorder:
    """Backend that records each allreduce bucket as (shapes, dtype) and
    holds a barrier until released."""

    name = "recorder"

    def __init__(self):
        self.buckets = []
        self.release = threading.Event()
        self.in_barrier = threading.Event()

    def allreduce(self, arrays, op, process_set, prescale=None,
                  postscale=None):
        self.buckets.append(([tuple(a.shape) for a in arrays],
                             str(arrays[0].dtype).replace("torch.", "")))
        return list(arrays)

    def barrier(self, process_set):
        self.in_barrier.set()
        assert self.release.wait(60)


_PS = types.SimpleNamespace(process_set_id=0, ranks=[0])


def _jax_coordinator(backend):
    rt = types.SimpleNamespace(topology=types.SimpleNamespace(rank=0, size=1),
                               mode="single", backend=backend, timeline=None,
                               autotuner=None)
    return jcoord.Coordinator(rt), jcoord.TensorEntry, JDuplicate, JInternal


def _port_coordinator(backend):
    rt = types.SimpleNamespace(topology=types.SimpleNamespace(rank=0, size=1),
                               mode="single", backend=backend, timeline=None,
                               device=torch.device("cpu"))
    return tcoord.Coordinator(rt), tcoord.TensorEntry, TDuplicate, TInternal


MAKERS = {"jax": _jax_coordinator, "port": _port_coordinator}


def _arrays(pkg, arrays):
    if pkg == "jax":
        return list(arrays)
    return [torch.from_numpy(a.copy()) for a in arrays]


def _draw(seed, n=40):
    """n entries: 1-3 tensors each of 1-3 dims, a dtype, an op, scales."""
    rng = np.random.RandomState(seed)
    ops = [reduce_ops.Average, reduce_ops.Sum]
    out = []
    for i in range(n):
        dtype = [np.float32, np.float16][rng.randint(2)]
        k = 1 if rng.rand() < 0.7 else rng.randint(2, 4)
        arrays = [rng.randn(*rng.randint(1, 20, size=rng.randint(1, 4)))
                  .astype(dtype) for _ in range(k)]
        out.append((f"t{i}", arrays, ops[rng.randint(2)],
                    [1.0, 0.5][rng.randint(2)], [1.0, 4.0][rng.randint(2)]))
    return out


def _held(coord, backend, entry_cls):
    """Submit the blocking barrier; returns once the cycle thread holds
    it."""
    coord.submit(entry_cls("hold", "barrier", [], _PS))
    assert backend.in_barrier.wait(60)


def _buckets(pkg, seed, threshold, monkeypatch):
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", str(threshold))
    backend = _Recorder()
    coord, entry_cls, _, _ = MAKERS[pkg](backend)
    coord.start()
    try:
        _held(coord, backend, entry_cls)
        handles = [coord.submit(entry_cls(
            name, "allreduce", _arrays(pkg, arrays), _PS, op=op,
            prescale=pre, postscale=post))
            for name, arrays, op, pre, post in _draw(seed)]
        backend.release.set()
        for h in handles:
            h.wait(60)
    finally:
        coord.stop()
    return backend.buckets


@pytest.mark.parametrize("threshold", [256, 4096, 1 << 27])
@pytest.mark.parametrize("seed", range(4))
def test_fusion_buckets_match_the_jax_package(seed, threshold, monkeypatch):
    want = _buckets("jax", seed, threshold, monkeypatch)
    got = _buckets("port", seed, threshold, monkeypatch)
    assert got == want
    assert len(want) > (1 if threshold == 1 << 27 else 8)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_duplicate_in_flight_name_raises(pkg):
    backend = _Recorder()
    coord, entry_cls, dup_cls, _ = MAKERS[pkg](backend)
    coord.start()
    try:
        _held(coord, backend, entry_cls)
        a = _arrays(pkg, [np.ones(3, np.float32)])
        first = coord.submit(entry_cls("same", "allreduce", a, _PS))
        with pytest.raises(dup_cls, match="same"):
            coord.submit(entry_cls("same", "allreduce", a, _PS))
        backend.release.set()
        first.wait(60)
    finally:
        coord.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_name_is_free_again_after_wait(pkg):
    backend = _Recorder()
    backend.release.set()
    coord, entry_cls, _, _ = MAKERS[pkg](backend)
    coord.start()
    try:
        for _ in range(5):
            a = _arrays(pkg, [np.ones(3, np.float32)])
            coord.submit(entry_cls("again", "allreduce", a, _PS)).wait(60)
    finally:
        coord.stop()
    assert len(backend.buckets) == 5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_stop_fails_queued_handles(pkg):
    backend = _Recorder()
    coord, entry_cls, _, internal = MAKERS[pkg](backend)
    coord.start()
    _held(coord, backend, entry_cls)
    queued = coord.submit(entry_cls(
        "queued", "allreduce", _arrays(pkg, [np.ones(3, np.float32)]), _PS))
    stopper = threading.Thread(target=coord.stop)
    stopper.start()
    while coord._running:
        pass
    backend.release.set()   # the cycle ends; the loop sees the stop
    stopper.join(60)
    assert not stopper.is_alive()
    with pytest.raises(internal, match="shut down"):
        queued.wait(60)
    with pytest.raises(internal, match="shut down"):
        coord.submit(entry_cls("late", "barrier", [], _PS))


def test_the_port_duplicate_message_names_both_call_sites():
    backend = _Recorder()
    coord, entry_cls, dup_cls, _ = _port_coordinator(backend)
    coord.start()
    try:
        _held(coord, backend, entry_cls)
        a = [torch.ones(3)]
        coord.submit(entry_cls("site", "allreduce", a, _PS))
        with pytest.raises(dup_cls) as err:
            coord.submit(entry_cls("site", "allreduce", a, _PS))
        backend.release.set()
    finally:
        coord.stop()
    assert str(err.value).count(__file__) == 2


def test_auto_names_agree_for_the_same_call_site():
    tcoll.reset_auto_name_counters()
    jcoll.reset_auto_name_counters()
    for _ in range(3):
        pair = jcoll._auto_name("allreduce"), tcoll._auto_name("allreduce")
        assert pair[0] == pair[1]
    assert pair[1].endswith("#3")
    assert ":test_auto_names_agree_for_the_same_call_site:" in pair[1]


def test_python_timeline_is_chrome_trace_json_like_the_jax_package(
        tmp_path):
    events = {}
    for pkg, cls in (("jax", JTimeline), ("port", TTimeline)):
        path = tmp_path / f"{pkg}.json"
        tl = cls(str(path), mark_cycles=True)
        tl.start()
        tl.begin(["a", "b"], "FUSED_ALLREDUCE")
        tl.marker("CYCLE_START")
        tl.end(["a", "b"], "FUSED_ALLREDUCE")
        tl.begin(["c"], "BROADCAST")
        tl.end(["c"], "BROADCAST")
        tl.stop()
        events[pkg] = [{k: v for k, v in e.items() if k != "ts"}
                       for e in json.loads(path.read_text())]
    assert events["port"] == events["jax"]
    assert len(events["port"]) == 7


@pytest.mark.parametrize("on", [False, True])
def test_metrics_are_null_unless_enabled(on, monkeypatch):
    # HOROVOD_TPU_METRICS off: every factory returns the shared no-op, as
    # in the JAX package; on, the coordinator's series count what it did.
    from horovod_tpu_torch.telemetry import core as tele
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "1" if on else "0")
    monkeypatch.setattr(tele, "_ENABLED", None)
    monkeypatch.setattr(tele, "_FAMILIES", {})
    backend = _Recorder()
    backend.release.set()
    coord, entry_cls, _, _ = _port_coordinator(backend)
    coord.start()
    try:
        coord.submit(entry_cls("m", "allreduce", [torch.ones(4)],
                               _PS)).wait(60)
    finally:
        coord.stop()
    fused = coord._m_fused_bytes.labels(dtype="torch.float32")
    if not on:
        assert coord._m_fused_bytes is tele.NULL and fused.value == 0.0
        return
    assert fused.value == 16.0
    assert tele.histogram("hvd_coordinator_cycle_seconds") is \
        coord._m_cycle_s
