"""Runtime submission-order guard (port of
``horovod_tpu/analysis/order_guard.py``).

The static layers cannot see dynamically built name streams, so this is
the dynamic backstop (the analog of the reference controller noticing
rank-divergent request streams, reference: horovod/common/controller.cc
ComputeResponseList + stall_inspector.cc). Opt-in via
``HOROVOD_TPU_ORDER_CHECK=1``:

- every coordinator submission appends the tensor name to a running
  SHA-1 stream hash, and a **checkpoint digest** is snapshotted every
  ``checkpoint_every`` submissions;
- in a launcher job a background checker periodically allgathers each
  rank's recent checkpoint digests and compares them at the newest
  submission index all ranks have reached; divergence raises
  :class:`SubmissionOrderError` naming the disagreeing ranks and the
  bounding submission window (ranks at different submission counts are
  compared at a common checkpoint, not flagged for mere skew);
- in a single-process job the sequence is recorded instead and can be
  dumped as JSON (``HOROVOD_TPU_ORDER_CHECK_RECORD=<path>``).

numpy and hashlib only (the payloads ride the allgather as uint8
tensors). When the guard is off the coordinator holds ``None``: the hot
path pays one attribute check and allocates nothing.
"""

import hashlib
import json
import struct
import threading
from collections import deque

import numpy as np

from ..exceptions import SubmissionOrderError

#: Prefix of the guard's own collectives (``hvdlint.order_check.<round>``):
#: each rank submits them on its own timer, at rank-dependent points of the
#: stream, so they stay out of the digest stream, the consistency check
#: and the stall scan.
GUARD_PREFIX = "hvdlint."
DEFAULT_CHECKPOINT_EVERY = 64
DEFAULT_WINDOW = 16
_DIGEST_LEN = hashlib.sha1().digest_size  # 20
_HEADER = struct.Struct("<QQQ")  # checkpoint_every, latest_idx, n_digests


class SubmissionOrderGuard:
    """Per-process submission-sequence hasher + cross-rank comparator."""

    def __init__(self, rank=0, record=False,
                 checkpoint_every=DEFAULT_CHECKPOINT_EVERY,
                 window=DEFAULT_WINDOW, max_record=100_000):
        self.rank = rank
        self.checkpoint_every = int(checkpoint_every)
        self.window = int(window)
        self._hash = hashlib.sha1()
        self._count = 0
        self._lock = threading.Lock()
        # (checkpoint_index, digest) pairs; index k covers the first
        # k * checkpoint_every submissions.
        self._checkpoints = deque(maxlen=self.window)
        self._record = [] if record else None
        self._max_record = int(max_record)
        self.truncated = False

    # -- recording (coordinator submit path) ------------------------------
    def record(self, name, kind="", callsite=None):
        with self._lock:
            self._hash.update(name.encode("utf-8", "replace"))
            self._hash.update(b"\x00")
            self._count += 1
            if self._count % self.checkpoint_every == 0:
                self._checkpoints.append(
                    (self._count // self.checkpoint_every,
                     self._hash.copy().digest()))
            if self._record is not None:
                if len(self._record) < self._max_record:
                    self._record.append({
                        "n": self._count, "name": name, "kind": kind,
                        "site": callsite})
                else:
                    self.truncated = True

    @property
    def count(self):
        return self._count

    def digest(self):
        """Full-stream digest + count (exact comparison when two ranks
        are known to sit at the same submission count)."""
        with self._lock:
            return self._hash.copy().digest() + struct.pack(
                "<Q", self._count)

    # -- cross-rank protocol ----------------------------------------------
    def sync_payload(self):
        """Fixed-size uint8 array carrying the recent checkpoint digests;
        one allgather of these per check, any rank count."""
        with self._lock:
            cps = list(self._checkpoints)
        latest = cps[-1][0] if cps else 0
        buf = bytearray(_HEADER.pack(self.checkpoint_every, latest,
                                     len(cps)))
        for _, dg in cps:
            buf += dg
        buf += b"\x00" * ((self.window - len(cps)) * _DIGEST_LEN)
        return np.frombuffer(bytes(buf), dtype=np.uint8).copy()

    @staticmethod
    def _parse_payload(row):
        raw = bytes(np.asarray(row, dtype=np.uint8).tobytes())
        every, latest, n = _HEADER.unpack_from(raw, 0)
        digests = {}
        off = _HEADER.size
        for i in range(n):
            idx = latest - (n - 1 - i)
            digests[idx] = raw[off + i * _DIGEST_LEN:
                               off + (i + 1) * _DIGEST_LEN]
        return every, latest, digests

    @staticmethod
    def compare_payloads(rows):
        """Compare per-rank ``sync_payload`` rows (index = rank).

        Returns the checkpoint index compared, or ``None`` when no
        common checkpoint exists yet (early in the run / extreme skew).
        Raises :class:`SubmissionOrderError` on divergence.
        """
        parsed = [SubmissionOrderGuard._parse_payload(r) for r in rows]
        everies = {p[0] for p in parsed}
        if len(everies) != 1:
            raise ValueError(
                f"ORDER_CHECK checkpoint_every differs across ranks "
                f"({sorted(everies)}); set the same "
                "HOROVOD_TPU_ORDER_CHECK configuration everywhere")
        every = everies.pop()
        if any(p[1] == 0 for p in parsed):
            return None  # some rank has no checkpoint yet
        common = min(p[1] for p in parsed)
        if any(common not in p[2] for p in parsed):
            return None  # slid out of a rank's window
        groups = {}
        for rank, p in enumerate(parsed):
            groups.setdefault(p[2][common], []).append(rank)
        if len(groups) > 1:
            desc = "; ".join(
                f"ranks {r} -> {dg[:6].hex()}"
                for dg, r in sorted(groups.items(), key=lambda kv: kv[1]))
            raise SubmissionOrderError(
                f"collective submission order diverged across ranks "
                f"within the first {common * every} submissions "
                f"({desc}). Ranks are enqueueing named tensors in "
                "different orders or with different auto-generated "
                "names — typically a rank-dependent code path. Run "
                "`hvd-lint` on the training script (rules HVD201/"
                "HVD203, docs/lint.md); set "
                "HOROVOD_TPU_ORDER_CHECK_RECORD=<path> to dump each "
                "rank's sequence for diffing.")
        return common

    def verify(self, gathered, num_ranks):
        """Split a stacked/concatenated allgather result into per-rank
        rows and compare. Returns the checkpoint index compared."""
        arr = np.asarray(gathered, dtype=np.uint8).reshape(num_ranks, -1)
        return self.compare_payloads(list(arr))

    # -- fixture-corpus recording -----------------------------------------
    def dump(self, path):
        """Write the recorded sequence as JSON (one file per rank when
        the path contains ``{rank}``)."""
        if "{rank}" in path:
            path = path.format(rank=self.rank)
        with self._lock:
            payload = {
                "rank": self.rank,
                "count": self._count,
                "checkpoint_every": self.checkpoint_every,
                "digest": self._hash.copy().hexdigest(),
                "truncated": self.truncated,
                "sequence": list(self._record or ()),
            }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        return path
