"""Process sets: concurrent sub-communicators (port of
``horovod_tpu/process_sets.py``; reference: horovod/common/process_sets.py).

Every rank of the job registers the same sets in the same order
(``add_process_set`` is collective, as in the reference): each set gets an
id from the runtime's table, and in a launcher job it is registered with
the native core, which negotiates on it once every rank has, and (on the
delegated plane) gets its own ``torch.distributed`` group. A collective on
a set runs among its members only; a rank outside the set that calls it
gets an error from the native core.
"""

import threading


class ProcessSet:
    """A set of ranks able to run collectives among themselves."""

    process_set_id = None

    def __init__(self, ranks):
        self.ranks = sorted(int(r) for r in ranks)
        if len(set(self.ranks)) != len(self.ranks):
            raise ValueError("Duplicate ranks in process set")

    def size(self):
        if self.process_set_id is None:
            return None
        return len(self.ranks)

    def rank(self):
        """This process's rank within the set, or None if not included."""
        if self.process_set_id is None:
            return None
        from . import basics
        me = basics.rank()
        return self.ranks.index(me) if me in self.ranks else None

    def included(self):
        if self.process_set_id is None:
            return None
        from . import basics
        return basics.rank() in self.ranks

    def __eq__(self, other):
        return (type(self) == type(other)
                and self.process_set_id == other.process_set_id
                and self.ranks == other.ranks)

    def __hash__(self):
        return hash((self.process_set_id, tuple(self.ranks)))

    def __str__(self):
        return (f"ProcessSet(process_set_id={self.process_set_id}, "
                f"ranks={self.ranks})")


class _ProcessSetTable:
    """Id-indexed registry of the live sets (reference:
    horovod/common/process_set.h:89-171)."""

    def __init__(self, size, backend):
        self._lock = threading.Lock()
        self._by_id = {}
        self._next_id = 0
        self._size = size
        self._backend = backend

    def register(self, ps):
        with self._lock:
            for existing in self._by_id.values():
                if existing.ranks == ps.ranks:
                    raise ValueError(
                        f"A process set with ranks {ps.ranks} already "
                        f"exists (id={existing.process_set_id})")
            for r in ps.ranks:
                if not 0 <= r < self._size:
                    raise ValueError(f"Rank {r} in process set out of range "
                                     f"[0, {self._size})")
            ps.process_set_id = self._next_id
            self._next_id += 1
            self._backend.add_process_set(ps)
            self._by_id[ps.process_set_id] = ps
            return ps

    def remove(self, ps):
        with self._lock:
            if ps.process_set_id is None:
                return
            if ps.process_set_id == 0:
                raise ValueError("Cannot remove the global process set")
            self._by_id.pop(ps.process_set_id, None)
            self._backend.remove_process_set(ps)
            ps.process_set_id = None

    def get(self, set_id):
        with self._lock:
            return self._by_id.get(set_id)

    def all(self):
        with self._lock:
            return list(self._by_id.values())


global_process_set = ProcessSet([])


def _setup(runtime):
    """Build the runtime's table and register the global set over every
    rank (called by init)."""
    runtime.process_set_table = _ProcessSetTable(runtime.topology.size,
                                                 runtime.backend)
    global_process_set.ranks = list(range(runtime.topology.size))
    runtime.process_set_table.register(global_process_set)


def _teardown(runtime):
    """Invalidate every registered set, so that a later init() registers
    them again against the fresh runtime (called by shutdown)."""
    for ps in runtime.process_set_table.all():
        ps.process_set_id = None


def add_process_set(process_set):
    """Register a set of ranks after init; every rank calls this with the
    same ranks, in the same order (reference:
    horovod/common/process_sets.py:123). Returns the registered set."""
    from . import basics
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    return basics.runtime().process_set_table.register(process_set)


def remove_process_set(process_set):
    """Remove a registered set (reference:
    horovod/common/process_sets.py:145)."""
    from . import basics
    basics.runtime().process_set_table.remove(process_set)
    return True


def process_set_by_id(set_id):
    from . import basics
    ps = basics.runtime().process_set_table.get(set_id)
    if ps is None:
        raise ValueError(f"No process set with id {set_id}")
    return ps
