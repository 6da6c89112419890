"""Paged KV cache: fixed-size page pool per host, page tables per
sequence (port of ``horovod_tpu/serving/kv_cache.py``).

The KV cache is the scarce resource of continuous batching: every
in-flight sequence owns ceil(tokens / page_size) pages of attention
state, and admission control is what keeps the pool from thrashing. The
design is the paged-attention formulation — a fixed pool of fixed-size
pages, per-sequence page tables mapping logical token positions to
physical pages — with two policies layered on top:

- **watermark admission**: a prefill is admitted only when the pool
  would keep ``watermark`` free pages after allocating the prompt; the
  reserve is what lets already-running sequences keep growing during
  decode instead of deadlocking against new arrivals.
- **preemption**: when decode growth does exhaust the pool, the
  scheduler frees a victim sequence's pages wholesale
  (:meth:`PageTable.release`) and re-runs its prefill when pages free
  up — recompute-on-resume, exact for deterministic models.

The page payload (``kv_dim`` > 0) is one float32 tensor of shape
``(num_pages, page_size, kv_dim)`` on the pool's device (the GPU unless
the caller passes ``device="cpu"``). :meth:`PageTable.append` writes
slots with one indexed copy, :meth:`PagePool.gather_many` reads the
contexts of a whole batch back in token order with one more. Index
tensors reach the card from pinned host memory without making the host
wait, and every copy of the plane runs on the device's default stream,
whichever thread makes it: a page freed under a running decode is
rewritten only after that decode's gather has read it. The free list
is host bookkeeping, LIFO, and allocates in the JAX pool's order.

Live migration exports a sequence's pages in table order — each page
carrying a sha256 digest of its used slots, float32 little-endian, the
JAX pool's bytes, so a record moves between the two packages unchanged.
The pages leave the card once, in one device-to-host copy that has
finished before any digest is taken. An import verifies every digest
*before* a single page is allocated, so a refused import leaves the
target pool untouched.
"""

import base64
import contextlib
import hashlib
import threading

import numpy as np
import torch

# The watermark admission predicate is the protocol spec's (one
# function for prefill admission, import placement, and the model
# checker's invariant).
from ..analysis.protocol.migration_spec import admits
from . import metrics as _m

#: Default reserve fraction: admission keeps 1/16 of the pool free.
WATERMARK_FRACTION = 16


def resolve_device(device):
    """The device a serving object keeps its tensors on: ``device`` when
    given, else the current CUDA device; without CUDA it raises rather
    than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.serving: no CUDA device is available. The "
            "serving plane runs on the GPU; pass device='cpu' to run on "
            "the CPU explicitly.")
    return torch.device("cuda", torch.cuda.current_device())


def device_stream(device):
    """The one stream every copy of the serving plane runs on: the
    device's default stream (a no-op context on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.stream(torch.cuda.default_stream(device))
    return contextlib.nullcontext()


def to_device(values, device, dtype):
    """``values`` (host ints or floats, a numpy array or a tensor) as a
    ``dtype`` tensor on ``device``. Host data reaches the card from
    pinned memory with a non-blocking copy: the host does not wait."""
    t = values if torch.is_tensor(values) else torch.as_tensor(
        np.asarray(values))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.to(dtype).pin_memory().to(device, non_blocking=True)
    return t.to(device=device, dtype=dtype)


class PoolExhausted(RuntimeError):
    """Raised by :meth:`PagePool.alloc` when the pool cannot satisfy an
    allocation; the scheduler catches it and preempts."""


class MigrationError(RuntimeError):
    """Base of every export/import refusal. Every subtype is raised
    *before* the target pool is mutated (all-or-nothing), so a failed
    migration leaves the importer exactly as it was and the caller
    falls back to recompute (the graceful-degradation contract)."""


class DigestMismatch(MigrationError):
    """A page payload does not match its sha256 digest — corruption in
    transit. Import refuses the whole record."""


class GeometryMismatch(MigrationError):
    """The record's page_size/kv_dim/page-count does not fit this
    pool — migrating between incompatible serving configurations."""


class NoHeadroom(MigrationError):
    """Placing the record would dip below this pool's admission
    watermark; the target has no room to host a *growing* sequence."""


class PagePool:
    """Fixed pool of ``num_pages`` pages, ``page_size`` token slots
    each, its payload on ``device``. Thread-safe bookkeeping; the free
    list is LIFO so hot pages stay hot."""

    def __init__(self, num_pages, page_size, kv_dim=0, watermark=None,
                 device=None):
        num_pages = int(num_pages)
        page_size = int(page_size)
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"page pool needs >=1 pages of >=1 tokens, got "
                f"{num_pages} x {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dim = int(kv_dim)
        if watermark is None:
            watermark = max(1, num_pages // WATERMARK_FRACTION)
        if watermark >= num_pages:
            raise ValueError(
                f"watermark {watermark} leaves no usable pages of "
                f"{num_pages}")
        self.watermark = int(watermark)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._free = list(range(num_pages - 1, -1, -1))
        self.data = (torch.zeros((num_pages, page_size, self.kv_dim),
                                 dtype=torch.float32, device=self.device)
                     if self.kv_dim else None)
        _m.kv_pages_free().set(num_pages)

    # -- accounting --------------------------------------------------------
    @property
    def free_pages(self):
        with self._lock:
            return len(self._free)

    def pages_needed(self, tokens):
        return -(-int(tokens) // self.page_size)  # ceil div

    def can_admit(self, tokens):
        """Watermark admission check: would allocating ``tokens`` worth
        of pages keep the reserve intact?"""
        with self._lock:
            return admits(len(self._free), self.pages_needed(tokens),
                          self.watermark)

    # -- alloc/free --------------------------------------------------------
    def alloc(self, n):
        """``n`` page ids, or :class:`PoolExhausted` (allocation is
        all-or-nothing so a failed grab never strands partial pages)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise PoolExhausted(
                    f"need {n} pages, {len(self._free)} free "
                    f"(pool {self.num_pages})")
            pages = [self._free.pop() for _ in range(n)]
            free_now = len(self._free)
        _m.kv_pages_free().set(free_now)
        return pages

    def alloc_admit(self, n):
        """``n`` page ids, refused with :class:`NoHeadroom` when the
        grab would dip below the admission watermark. The check and the
        allocation are one critical section — an import can never race
        another allocator into the reserve."""
        n = int(n)
        with self._lock:
            if not admits(len(self._free), n, self.watermark):
                raise NoHeadroom(
                    f"import needs {n} pages but only "
                    f"{len(self._free)} free over a watermark of "
                    f"{self.watermark} (pool {self.num_pages})")
            pages = [self._free.pop() for _ in range(n)]
            free_now = len(self._free)
        _m.kv_pages_free().set(free_now)
        return pages

    def free(self, pages):
        with self._lock:
            self._free.extend(pages)
            free_now = len(self._free)
        _m.kv_pages_free().set(free_now)

    # -- payload -----------------------------------------------------------
    def _slot_ids(self, pages, start, count):
        """Flat slot ids (page * page_size + slot) of token positions
        ``start .. start + count - 1`` of a table over ``pages``."""
        pos = np.arange(start, start + count, dtype=np.int64)
        return (np.asarray(pages, np.int64)[pos // self.page_size]
                * self.page_size + pos % self.page_size)

    def _slots(self):
        return self.data.view(-1, self.kv_dim)

    def write(self, pages, start, vecs):
        """Write ``(k, kv_dim)`` vectors at token positions ``start ..
        start + k - 1`` of a table over ``pages`` (one indexed copy)."""
        k = int(vecs.shape[0])
        if not k:
            return
        with device_stream(self.device):
            self._slots().index_copy_(
                0, to_device(self._slot_ids(pages, start, k), self.device,
                             torch.int64),
                to_device(vecs, self.device, torch.float32).reshape(
                    k, self.kv_dim))

    def gather_many(self, tables):
        """The contexts of ``tables``, each ``(num_tokens, kv_dim)`` in
        token order: one indexed copy for the whole batch, split into
        views."""
        if self.data is None:
            raise ValueError("pool carries no KV payload (kv_dim=0)")
        lengths = [t.num_tokens for t in tables]
        ids = [self._slot_ids(t.pages, 0, t.num_tokens) for t in tables]
        flat_ids = (np.concatenate(ids) if ids
                    else np.zeros(0, np.int64))
        with device_stream(self.device):
            flat = self._slots().index_select(
                0, to_device(flat_ids, self.device, torch.int64))
        return list(flat.split(lengths))

    # -- live migration ----------------------------------------------------
    def export_sequence(self, table):
        """One sequence's KV state as a wire record: page payloads in
        table order, each with a sha256 digest, plus the pool geometry
        the importer must match. Sequence metadata (prompt, generated
        tokens, next position) is layered on by the scheduler."""
        n_tokens = table.num_tokens
        ps = self.page_size
        host = None
        if self.data is not None and n_tokens:
            # The pages leave the card once; .cpu() returns after the
            # copy has finished, so the digests read final bytes.
            host = np.ascontiguousarray(
                self.gather_many([table])[0].cpu().numpy(), "<f4")
        pages = []
        for idx in range(len(table.pages)):
            used = min(ps, n_tokens - idx * ps)
            raw = (host[idx * ps:idx * ps + used].tobytes()
                   if host is not None else b"")
            pages.append({
                "payload": base64.b64encode(raw).decode("ascii"),
                "digest": hashlib.sha256(raw).hexdigest(),
            })
        return {"num_tokens": n_tokens, "page_size": ps,
                "kv_dim": self.kv_dim, "pages": pages}

    def import_sequence(self, record):
        """Place an exported record into this pool; returns the new
        :class:`PageTable`. All-or-nothing: geometry and every page
        digest are verified *before* any page is allocated, and the
        allocation itself is watermark-fenced (:meth:`alloc_admit`) —
        any raise leaves the pool's free count exactly as it was."""
        if (int(record["page_size"]) != self.page_size
                or int(record["kv_dim"]) != self.kv_dim):
            raise GeometryMismatch(
                f"record pages are {record['page_size']} slots x "
                f"kv_dim {record['kv_dim']}; this pool is "
                f"{self.page_size} x {self.kv_dim}")
        n_tokens = int(record["num_tokens"])
        pages_meta = record["pages"]
        if self.pages_needed(n_tokens) != len(pages_meta):
            raise GeometryMismatch(
                f"{n_tokens} tokens need "
                f"{self.pages_needed(n_tokens)} pages, record carries "
                f"{len(pages_meta)}")
        ps = self.page_size
        payloads = []
        for idx, pg in enumerate(pages_meta):
            raw = base64.b64decode(pg["payload"])
            if hashlib.sha256(raw).hexdigest() != pg["digest"]:
                raise DigestMismatch(
                    f"page {idx}/{len(pages_meta)} payload does not "
                    f"match its sha256 digest")
            used = min(ps, n_tokens - idx * ps)
            if self.kv_dim and len(raw) != used * self.kv_dim * 4:
                raise GeometryMismatch(
                    f"page {idx} carries {len(raw)} bytes, expected "
                    f"{used * self.kv_dim * 4}")
            payloads.append(raw)
        pages = self.alloc_admit(len(pages_meta))   # NoHeadroom
        table = PageTable(self)
        table.pages = pages
        table.num_tokens = n_tokens
        if self.data is not None and n_tokens:
            self.write(pages, 0, np.frombuffer(
                b"".join(payloads), "<f4").reshape(
                    n_tokens, self.kv_dim).copy())
        return table


class PageTable:
    """One sequence's mapping of logical token positions to physical
    pages. Owned by a single scheduler thread — not itself locked (the
    pool it allocates from is)."""

    __slots__ = ("pool", "pages", "num_tokens")

    def __init__(self, pool):
        self.pool = pool
        self.pages = []
        self.num_tokens = 0

    @property
    def capacity(self):
        return len(self.pages) * self.pool.page_size

    def ensure_capacity(self, total_tokens):
        """Grow the table to hold ``total_tokens``; raises
        :class:`PoolExhausted` (all-or-nothing) when the pool can't."""
        need = self.pool.pages_needed(total_tokens) - len(self.pages)
        if need > 0:
            self.pages.extend(self.pool.alloc(need))

    def append(self, vecs):
        """Write ``(k, kv_dim)`` KV vectors (a tensor, or host data) at
        the next ``k`` token slots, allocating pages as needed."""
        k = int(vecs.shape[0])
        self.ensure_capacity(self.num_tokens + k)
        if self.pool.data is not None:
            self.pool.write(self.pages, self.num_tokens, vecs)
        self.num_tokens += k

    def gather(self):
        """The sequence's KV context, ``(num_tokens, kv_dim)``, read
        back through the page table in token order."""
        return self.pool.gather_many([self])[0]

    def release(self):
        """Free every page (preemption / completion). The table resets
        to empty so a resume re-appends from position 0."""
        if self.pages:
            self.pool.free(self.pages)
        self.pages = []
        self.num_tokens = 0
