"""Crash-safe disk checkpoints (port of ``horovod_tpu/checkpoint.py``).

The distributed etiquette: rank 0 writes and every rank waits at a
barrier, so that no rank trains on against a save in flight; rank 0 reads
and broadcasts, so that every rank starts from the same bytes and a
corrupt file fails every rank instead of stranding the others in the
broadcast. The durability etiquette:

- **Atomic writes**: tmp file, flush, fsync, ``os.replace``, then an fsync
  of the directory. A crash mid-save leaves the old checkpoint or the new
  one, never a torn file at the final name.
- **Integrity footer**: ``MAGIC | payload | sha256 | length | MAGIC``;
  ``restore`` verifies before it unpickles and raises
  ``CheckpointCorruptError`` on damage.
- **Fallback restore**: ``restore_latest`` restores the newest *intact*
  ``step_<N>``, warning about and counting (``hvd_checkpoint_corrupt_total``)
  every corrupt file it skips.
- **Retention**: ``HVDTPU_CHECKPOINT_KEEP=N`` prunes all but the newest N
  steps after each ``save_step``.

The file format is the JAX package's: a pickle of plain Python containers
and numpy arrays. Tensors (CPU or CUDA) become numpy arrays on the way in,
so a file of float32 and integer leaves reads the same in both packages,
either way round, and ``restore`` hands back numpy leaves
(:func:`to_tensors` turns them back into tensors). Dtypes numpy lacks
(``bfloat16``, the float8 types) are stored widened to float32: the
widening is exact, so copying a restored leaf back into a 16-bit tensor
(``load_state_dict``, ``copy_``) gives the saved bits again. The payload
is pickled straight into the file while its hash is taken, so a save holds
no second copy of the state in memory.

The JAX package's legacy orbax directories are not read here: restoring
one raises, naming that format. ``checkpoint`` is a chaos injection point
(``checkpoint:corrupt`` flips payload bytes after the file lands), so the
fallback to an older intact step is rehearsable on demand.

    from horovod_tpu_torch import checkpoint as ckpt

    ckpt.save_step(directory, step, {"model": model.state_dict(),
                                     "opt": dist_opt.state_dict()})
    step, state = ckpt.restore_latest(directory)   # newest intact step
    model.load_state_dict(ckpt.to_tensors(state["model"]))
    dist_opt.load_state_dict(state["opt"])
"""

import hashlib
import os
import pickle
import struct

import numpy as np
import torch

from . import basics
from . import chaos
from .exceptions import CheckpointCorruptError
from .telemetry import core as telemetry
from .utils import envparse
from .utils.logging_util import get_logger

MAGIC = b"HVDTPUCKPT1\n"
_FOOTER = struct.Struct("<32sQ")  # sha256(payload), payload length
_MIN_SIZE = len(MAGIC) * 2 + _FOOTER.size


def _m_corrupt():
    return telemetry.counter(
        "hvd_checkpoint_corrupt_total",
        "Checkpoint files that failed their integrity check")


def _spmd():
    if not basics.is_initialized():
        # Usable before init() (inspection tools, tests): no runtime, no
        # peers to coordinate with.
        return False
    rt = basics.runtime()
    return rt.mode == basics.MODE_SPMD and rt.topology.size > 1


def _rank():
    return basics.runtime().topology.rank


def _host_array(t):
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.to(torch.float32)
    return t.cpu().numpy().copy()


def _to_host(state):
    """Tensors (CPU or CUDA) to numpy arrays, through dicts, lists and
    tuples (named tuples and OrderedDicts keep their type); everything
    else as it is."""
    if isinstance(state, torch.Tensor):
        return _host_array(state)
    if isinstance(state, dict):
        out = {k: _to_host(v) for k, v in state.items()}
        # A module's state_dict is an OrderedDict: it stays one.
        return out if type(state) is dict else type(state)(out)
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[_to_host(v) for v in state])
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


def to_tensors(state, device=None):
    """numpy arrays of a restored state to tensors (on ``device``, the CPU
    by default), through dicts, lists and tuples."""
    if isinstance(state, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(state)).to(device)
    if isinstance(state, dict):
        return {k: to_tensors(v, device) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[to_tensors(v, device) for v in state])
    if isinstance(state, (list, tuple)):
        return type(state)(to_tensors(v, device) for v in state)
    return state


class _Hasher:
    """sha256 on a thread of its own, fed chunks that nobody writes to any
    more: hashing (which releases the GIL) overlaps the file's reads or
    writes."""

    def __init__(self):
        import queue
        import threading
        self._sha = hashlib.sha256()
        self._q = queue.Queue(maxsize=16)
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            chunk = self._q.get()
            if chunk is None:
                return
            self._sha.update(chunk)

    def update(self, chunk):
        self._q.put(chunk)

    def digest(self):
        self._q.put(None)
        self._t.join()
        return self._sha.digest()


class _HashingWriter:
    """A file wrapper that hashes and counts what is written through it."""

    def __init__(self, f):
        self._f = f
        self.hasher = _Hasher()
        self.length = 0

    def write(self, b):
        if isinstance(b, pickle.PickleBuffer):
            # A large array's own memory, handed over out of the frames.
            b = memoryview(b)
        else:
            # A frame: a copy, since the pickler may reuse its buffer.
            b = memoryview(memoryview(b).tobytes())
        self.hasher.update(b)
        self.length += b.nbytes
        return self._f.write(b)


def _write_file(path, state):
    """Atomic single-file write: MAGIC | payload | sha256 | len | MAGIC,
    via tmp + fsync + rename."""
    host = _to_host(state)
    directory = os.path.dirname(path) or "."
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            w = _HashingWriter(f)
            try:
                pickle.dump(host, w, protocol=pickle.HIGHEST_PROTOCOL)
            finally:
                digest = w.hasher.digest()
            f.write(_FOOTER.pack(digest, w.length))
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        # Persist the rename itself (the directory entry).
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        pass  # directories that refuse an O_RDONLY fsync (some FSes)
    try:
        chaos.inject("checkpoint", name=os.path.basename(path))
    except chaos.ChaosSignal as sig:
        if sig.action == "corrupt":
            _chaos_corrupt(path, w.length)


def _chaos_corrupt(path, payload_len):
    """Chaos ``checkpoint:corrupt``: flip bytes in the middle of the
    just-written payload (length preserved) so the checksum fails."""
    with open(path, "r+b") as f:
        f.seek(len(MAGIC) + max(0, payload_len // 2 - 8))
        chunk = f.read(16)
        f.seek(-len(chunk), os.SEEK_CUR)
        f.write(bytes(b ^ 0xFF for b in chunk))
    get_logger().warning("chaos: corrupted checkpoint payload in %s",
                         path)


def _verify_open(f, keep=False):
    """Check an open checkpoint file's framing and checksum: ``(ok,
    reason, payload)``, the payload (read while it is hashed, one pass
    over the file) only with ``keep``."""
    # One fd for the stat and the reads: a concurrent atomic save
    # replacing the path cannot mix two files.
    size = os.fstat(f.fileno()).st_size
    if size < _MIN_SIZE:
        return False, f"truncated ({size} bytes)", None
    head = f.read(len(MAGIC))
    if head != MAGIC:
        return False, "bad header magic (foreign or torn file)", None
    f.seek(size - len(MAGIC))
    if f.read(len(MAGIC)) != MAGIC:
        return False, "bad trailer magic (truncated write)", None
    f.seek(size - len(MAGIC) - _FOOTER.size)
    digest, payload_len = _FOOTER.unpack(f.read(_FOOTER.size))
    if len(MAGIC) + payload_len + _FOOTER.size + len(MAGIC) != size:
        return False, (f"length mismatch (footer says {payload_len} "
                       "payload bytes)"), None
    f.seek(len(MAGIC))
    h = _Hasher()
    payload = bytearray(payload_len) if keep else None
    view = memoryview(payload) if keep else None
    done = 0
    try:
        while done < payload_len:
            n = min(payload_len - done, 1 << 24)
            if keep:
                got = f.readinto(view[done:done + n])
                chunk = view[done:done + got]
            else:
                chunk = f.read(n)
                got = len(chunk)
            if not got:
                return False, "payload shorter than footer claims", None
            h.update(chunk)
            done += got
    finally:
        got_digest = h.digest()
    if got_digest != digest:
        return False, "checksum mismatch (payload corrupted)", None
    return True, "", payload


def verify_checkpoint(path):
    """Integrity check without unpickling. Returns ``(ok, reason)``; a
    directory (the JAX package's legacy orbax layout) reports ok, as the
    JAX package's check does: ``restore`` then says the port cannot read
    it."""
    if os.path.isdir(path):
        return True, "legacy orbax directory"
    try:
        with open(path, "rb") as f:
            ok, reason, _ = _verify_open(f)
    except OSError as exc:
        return False, f"unreadable: {exc}"
    return ok, reason


def _read_file(path):
    """Verify and unpickle in one pass over the file (the payload is
    hashed as it is read)."""
    try:
        with open(path, "rb") as f:
            ok, reason, payload = _verify_open(f, keep=True)
    except OSError as exc:
        ok, reason = False, f"unreadable: {exc}"
    if not ok:
        _m_corrupt().inc()
        raise CheckpointCorruptError(
            f"checkpoint {path} failed its integrity check: {reason}")
    return pickle.loads(payload)


def _read_any(path):
    if os.path.isdir(path):
        raise CheckpointCorruptError(
            f"checkpoint {path} is a directory: the JAX package's legacy "
            "orbax layout, which the port does not read. Restore it with "
            "horovod_tpu.checkpoint.restore and save it again as a file.")
    return _read_file(path)


def save(path, state):
    """Write ``state`` at ``path``: rank 0 writes atomically (tmp + fsync +
    rename + checksum footer), every rank waits at a barrier."""
    from .ops.collectives import barrier
    path = os.path.abspath(str(path))
    if not _spmd() or _rank() == 0:
        _write_file(path, state)
    if _spmd():
        barrier()


def restore(path):
    """Load and verify a checkpoint. In a multi-rank job rank 0 reads and
    broadcasts: one storage read per job, the same state everywhere.
    Raises ``CheckpointCorruptError`` on every rank when the file fails
    its integrity check (``restore_latest`` falls back to an older intact
    step)."""
    from .functions import broadcast_object
    path = os.path.abspath(str(path))
    state = None
    err = None
    if not _spmd() or _rank() == 0:
        try:
            state = _read_any(path)
        except (CheckpointCorruptError, OSError) as exc:
            if not _spmd():
                raise
            # Raising on rank 0 before the broadcast would strand every
            # other rank in it: the failure travels through the broadcast.
            err = f"{type(exc).__name__}: {exc}"
    if _spmd():
        err, state = broadcast_object((err, state), root_rank=0,
                                      name="ckpt.restore")
        if err is not None:
            raise CheckpointCorruptError(
                f"rank 0 could not restore {path}: {err}")
    return state


def save_step(directory, step, state):
    """Save under ``directory/step_<N>``, then prune to the newest
    ``HVDTPU_CHECKPOINT_KEEP`` steps (0 keeps everything)."""
    directory = str(directory)
    if not _spmd() or _rank() == 0:
        os.makedirs(directory, exist_ok=True)
    save(os.path.join(directory, f"step_{step}"), state)
    if not _spmd() or _rank() == 0:
        _apply_retention(directory)


def _apply_retention(directory):
    keep = envparse.get_int(envparse.CHECKPOINT_KEEP, 0)
    if keep <= 0:
        return
    import shutil
    for step in sorted(_list_steps(directory), reverse=True)[keep:]:
        path = os.path.join(directory, f"step_{step}")
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
        except OSError as exc:
            get_logger().warning("checkpoint retention: could not "
                                 "remove %s: %s", path, exc)


def _list_steps(directory):
    """Step numbers under ``directory``. Entries that are no checkpoint
    (editor files, ``.tmp.<pid>`` partials of a crashed writer) are
    skipped with a warning."""
    steps, skipped = [], []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            steps.append(int(name[5:]))
        except ValueError:
            skipped.append(name)
    if skipped:
        shown = ", ".join(sorted(skipped)[:5])
        more = "" if len(skipped) <= 5 else f" (+{len(skipped) - 5} more)"
        get_logger().warning(
            "checkpoint: ignoring %d non-checkpoint entr%s in %s: %s%s",
            len(skipped), "y" if len(skipped) == 1 else "ies",
            directory, shown, more)
    return steps


def latest_step(directory):
    """Highest step with a checkpoint under ``directory``, or None."""
    directory = str(directory)
    if not os.path.isdir(directory):
        return None
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _newest_intact(directory):
    """``(step, state)`` of the newest step whose file passes its check,
    each candidate read and verified in one pass; corrupt files are
    skipped (warned and counted). ``(None, None)`` without steps; raises
    ``CheckpointCorruptError`` when steps exist but none is intact:
    training from scratch over a damaged store would be worse than
    stopping."""
    if not os.path.isdir(directory):
        return None, None
    steps = sorted(_list_steps(directory), reverse=True)
    if not steps:
        return None, None
    log = get_logger()
    for step in steps:
        path = os.path.join(directory, f"step_{step}")
        try:
            state = _read_any(path)
        except CheckpointCorruptError as exc:
            log.warning("checkpoint: step %d is corrupt (%s); trying the "
                        "previous step", step, exc)
            continue
        if step != steps[0]:
            log.warning("checkpoint: falling back to step %d (newest intact "
                        "checkpoint under %s)", step, directory)
        return step, state
    raise CheckpointCorruptError(
        f"all {len(steps)} checkpoint(s) under {directory} failed their "
        f"integrity checks (steps {steps}); refusing to silently train "
        "from scratch")


def restore_latest(directory):
    """Restore the newest intact ``step_<N>``; returns ``(step, state)``,
    or ``(None, None)`` when the directory holds none. In a multi-rank job
    rank 0 reads (each candidate once) and broadcasts its pick and the
    state."""
    from .functions import broadcast_object
    directory = str(directory)
    step = state = None
    err = None
    if not _spmd() or _rank() == 0:
        try:
            step, state = _newest_intact(directory)
        except (CheckpointCorruptError, OSError) as exc:
            if not _spmd():
                raise
            err = f"{type(exc).__name__}: {exc}"
    if _spmd():
        err, step = broadcast_object((err, step), root_rank=0,
                                     name="ckpt.latest")
        if err is not None:
            raise CheckpointCorruptError(
                f"rank 0 could not pick a checkpoint under {directory}: "
                f"{err}")
        if step is not None:
            state = broadcast_object(state, root_rank=0,
                                     name="ckpt.restore")
    return (None, None) if step is None else (step, state)
