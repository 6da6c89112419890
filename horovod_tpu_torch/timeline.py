"""Chrome-trace timeline (port of ``horovod_tpu/timeline.py``; reference:
horovod/common/timeline.cc).

The coordinator and the delegated data plane emit begin/end events into a
queue; a writer thread streams them as Chrome ``trace_event`` JSON, one
lane per tensor name. ``start_timeline``/``stop_timeline`` in the torch
binding drive it at run time (reference: horovod/common/basics.py:156).
With ``profiler_dir`` a ``torch.profiler`` trace of the host and the card
is written beside it (the JAX package takes a ``jax.profiler`` trace
there).
"""

import json
import os
import queue
import threading
import time


class Timeline:
    def __init__(self, path, profiler_dir=None, mark_cycles=False):
        self.path = path
        # When set, the coordinator drops an instant event per cycle
        # (reference: --timeline-mark-cycles).
        self.mark_cycles = bool(mark_cycles)
        self._queue = queue.Queue()
        self._thread = None
        self._running = False
        self._profiler_dir = profiler_dir
        self._profiler = None

    # -- producer side -----------------------------------------------------
    def begin(self, names, activity):
        if self._running:
            self._queue.put(("B", tuple(names), activity,
                             time.perf_counter_ns() // 1000))

    def end(self, names, activity):
        if self._running:
            self._queue.put(("E", tuple(names), activity,
                             time.perf_counter_ns() // 1000))

    def marker(self, name, ts_us=None):
        """Instant event; ``ts_us`` stamps a time captured earlier."""
        if self._running:
            self._queue.put(("I", (name,), name,
                             ts_us if ts_us is not None
                             else time.perf_counter_ns() // 1000))

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._running:
            return
        file = open(self.path, "w")
        file.write("[\n")
        # A fresh queue per session, handed to the writer with its file: a
        # writer of an earlier session whose join timed out drains its own.
        self._queue = queue.Queue()
        self._running = True
        self._thread = threading.Thread(target=self._writer,
                                        args=(file, self._queue),
                                        name="hvd-torch-timeline",
                                        daemon=True)
        self._thread.start()
        if self._profiler_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()

    def stop(self):
        if not self._running:
            return
        self._running = False
        if self._profiler is not None:
            self._profiler.stop()
            os.makedirs(self._profiler_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(
                self._profiler_dir,
                os.path.basename(self.path) + ".device.json"))
            self._profiler = None
        self._queue.put(None)
        # The writer closes the file after the sentinel.
        self._thread.join(timeout=5)

    # -- writer thread -----------------------------------------------------
    @staticmethod
    def _emit_item(file, item, first, lanes):
        """Write one queued item: an event per name, formatted from the
        name's lane (its tid and JSON-escaped name, made once): the writer
        holds the GIL while it formats, against every other thread."""
        phase, names, activity, ts_us = item
        act = json.dumps(activity)
        out = []
        for name in names:
            lane = lanes.get(name)
            if lane is None:
                lane = lanes[name] = (len(lanes) + 1, json.dumps(name))
            if phase == "I":
                out.append(f'{{"name": {act}, "ph": "i", "ts": {ts_us}, '
                           f'"pid": 0, "tid": {lane[0]}, "s": "g"}}')
            else:
                out.append(f'{{"name": {act}, "cat": "hvd", "ph": "{phase}", '
                           f'"ts": {ts_us}, "pid": 0, "tid": {lane[0]}, '
                           f'"args": {{"tensor": {lane[1]}}}}}')
        if out:
            file.write(("" if first[0] else ",\n") + ",\n".join(out))
            first[0] = False

    def _writer(self, file, q):
        """One blocking get, then everything queued meanwhile, then one
        flush; ends, closing the file, at the stop sentinel. ``first`` and
        ``lanes`` belong to this writer alone."""
        first, lanes = [True], {}
        try:
            stop = False
            while not stop:
                item = q.get()
                if item is None:
                    break
                self._emit_item(file, item, first, lanes)
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        break
                    if item is None:
                        stop = True
                        break
                    self._emit_item(file, item, first, lanes)
                file.flush()
        finally:
            file.write("\n]\n")
            file.close()
