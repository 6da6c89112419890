"""Async data loading: background-thread prefetch mixin + device prefetch
(port of ``horovod_tpu/data/data_loader_base.py``).

The reference ships ``AsyncDataLoaderMixin`` — a background thread that
pre-loads batches into a bounded queue while the training step runs
(reference: horovod/data/data_loader_base.py:165). The second half is
``prefetch_to_device``: the next batches are copied from pinned host memory
to the GPU on a side CUDA stream while the current step computes, so the
input transfer never serializes with the step (the torch idiom of the JAX
package's ``jax.device_put`` prefetch).
"""

import collections.abc
import queue
import threading

import numpy as np
import torch


class BaseDataLoader:
    """Iterable loader interface (reference: data_loader_base.py:25)."""

    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        """Yield batches for one epoch."""
        raise NotImplementedError


class AsyncDataLoaderMixin:
    """Mix in BEFORE a loader class to overlap loading with training
    (reference: data_loader_base.py:165 — same contract: a daemon thread
    fills a bounded queue; ``close()`` tears it down).

        class AsyncParquetLoader(AsyncDataLoaderMixin, ParquetLoader):
            pass
    """

    def __init__(self, async_loader_queue_size=8, *args, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        self._async_queue = None
        self._async_thread = None
        self._async_stop = threading.Event()
        super().__init__(*args, **kwargs)

    def close_async_loader(self):
        """Stop the background thread (reference: close_async_loader)."""
        self._async_stop.set()
        if self._async_queue is not None:
            # Unblock a put()-blocked producer.
            try:
                while True:
                    self._async_queue.get_nowait()
            except queue.Empty:
                pass
        if self._async_thread is not None:
            self._async_thread.join(timeout=10)
            self._async_thread = None

    close = close_async_loader

    def _async_worker(self, q):
        try:
            for batch in super().__iter__():
                while not self._async_stop.is_set():
                    try:
                        q.put((batch, None), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._async_stop.is_set():
                    return
            q.put((None, None))  # epoch sentinel
        except Exception as e:  # noqa: BLE001 — re-raised on the consumer
            q.put((None, e))

    def __iter__(self):
        if self.async_loader_queue_size <= 0:
            yield from super().__iter__()
            return
        if self._async_thread is not None and self._async_thread.is_alive():
            # Previous epoch abandoned mid-iteration (consumer broke out):
            # tear its producer down before starting a new one, or the old
            # thread leaks blocked on the abandoned queue.
            self.close_async_loader()
        self._async_stop.clear()
        q = queue.Queue(maxsize=self.async_loader_queue_size)
        self._async_queue = q
        self._async_thread = threading.Thread(
            target=self._async_worker, args=(q,), daemon=True,
            name="hvdtpu-async-loader")
        self._async_thread.start()
        while True:
            batch, exc = q.get()
            if exc is not None:
                raise exc
            if batch is None:
                break
            yield batch
        self._async_thread.join(timeout=10)
        self._async_thread = None


def _map(fn, batch):
    """``fn`` over every tensor (or numpy array) of a nest of dicts, lists
    and tuples (named tuples included); other leaves pass as they are."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(batch)
    if isinstance(batch, collections.abc.Mapping):
        return type(batch)((k, _map(fn, v)) for k, v in batch.items())
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map(fn, v) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return batch


def _default_device():
    from .. import basics
    if not basics.is_initialized():
        raise RuntimeError(
            "prefetch_to_device: the runtime is not initialized; call "
            "horovod_tpu_torch.init() or pass devices=")
    return basics.device()


def prefetch_to_device(iterator, size=2, devices=None):
    """Wrap a host batch iterator so that the next ``size`` batches are
    already on (or on their way to) the device while the current step
    runs.

    A batch is any nest of tensors or numpy arrays. On a CUDA device each
    one is pinned, copied with ``.to(device, non_blocking=True)`` on a side
    CUDA stream, and followed by a CUDA event; before a batch is yielded
    the consumer's current stream waits on its event (the host does not),
    and its tensors are marked as used on that stream. The device is the
    first of ``devices`` or the runtime's; on a CPU device the batches are
    only converted to tensors.
    """
    device = torch.device(devices[0] if devices else _default_device())
    on_cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_cuda else None

    def as_tensor(x):
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    def put(batch):
        host = _map(as_tensor, batch)
        if not on_cuda:
            return _map(lambda t: t.to(device), host), None
        host = _map(lambda t: t if t.is_cuda or t.is_pinned()
                    else t.pin_memory(), host)
        with torch.cuda.stream(stream):
            out = _map(lambda t: t.to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def take(entry):
        batch, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            _map(lambda t: t.record_stream(consumer), batch)
        return batch

    buf = collections.deque()
    it = iter(iterator)

    def gen():
        try:
            while len(buf) < size:
                buf.append(put(next(it)))
        except StopIteration:
            pass
        while buf:
            out = take(buf.popleft())
            try:
                buf.append(put(next(it)))
            except StopIteration:
                pass
            yield out

    return gen()
