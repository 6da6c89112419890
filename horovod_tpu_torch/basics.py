"""Runtime singleton: topology, device, backend; init/shutdown (port of
``horovod_tpu/basics.py``).

The port runs the reference's execution model: one process per GPU, ranks
from the launcher's environment (the same ``HVDTPU_*``/``HOROVOD_*`` names
the JAX package reads, so one launcher serves both). Every collective goes
through the runtime's ``Coordinator``:

- ``single`` mode (no launcher environment): one process, the
  coordinator's Python plane on the loopback backend;
- ``spmd`` mode (``RANK`` and ``SIZE`` set, at any size, 1 included): the
  native core negotiates across the ranks listed in ``HVDTPU_PEERS``, and
  NCCL (CUDA tensors) or the native TCP ring or gloo (CPU tensors)
  executes (``backend.make_spmd_backend``). Under the port's launcher
  (``runner/launch.py``) the ranks gather ``HVDTPU_PEERS`` through its
  rendezvous store; an elastic worker (``HVDTPU_ELASTIC``) first fetches
  its rank from the store's newest membership version.

Entry points run on the card: ``init()`` picks ``cuda:<local_rank>`` (an
elastic worker: the card of its slot) and raises when there is no CUDA
device, unless the caller asks for the CPU with ``init(device="cpu")``.
"""

import atexit
import contextlib
import threading
import time

import torch

from .exceptions import NotInitializedError
from .utils import envparse
from .utils.logging_util import get_logger


class Topology:
    """Process-level topology (reference: horovod/common/basics.py:183-264)."""

    def __init__(self, rank, size, local_rank, local_size, cross_rank,
                 cross_size):
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size

    @classmethod
    def from_env(cls):
        rank = envparse.get_int(envparse.RANK, 0)
        size = envparse.get_int(envparse.SIZE, 1)
        local_rank = envparse.get_int(envparse.LOCAL_RANK, rank)
        local_size = envparse.get_int(envparse.LOCAL_SIZE, size)
        cross_rank = envparse.get_int(envparse.CROSS_RANK, 0)
        cross_size = envparse.get_int(envparse.CROSS_SIZE, 1)
        return cls(rank, size, local_rank, local_size, cross_rank, cross_size)


MODE_SINGLE = "single"
MODE_SPMD = "spmd"


class Runtime:
    """Owns topology, device, backend, coordinator, timeline and the
    process-set table."""

    def __init__(self, mode, topology, device, backend):
        self.mode = mode
        self.topology = topology
        self.device = device
        self.backend = backend
        self.process_set_table = None   # attached by process_sets._setup
        self.coordinator = None         # attached by init
        self.timeline = None            # HVDTPU_TIMELINE or start_timeline
        self.tracer = None              # tracing.Tracer, set by the coordinator
        self.metrics_pusher = None      # telemetry.MetricsPusher (launcher)
        self._shutdown = False

    def check_alive(self):
        if self._shutdown:
            raise NotInitializedError("Runtime was shut down; operations")


_runtime = None
_init_lock = threading.Lock()


def _card_index(topology):
    """The CUDA device index of this process. An elastic worker takes the
    slot index of its worker id (``host:<slot>``), not its local rank: the
    driver hands local ranks out again at every membership version,
    survivors first, so after a lost slot a survivor's local rank can name
    the card a respawned slot holds, or the other way round."""
    wid = envparse.get_str(envparse.WORKER_ID, "")
    if envparse.get_bool(envparse.ELASTIC) and wid:
        return int(wid.rpartition(":")[2])
    return topology.local_rank


def _pick_device(device, topology):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.init(): no CUDA device is available. The "
            "port runs on the GPU; pass device='cpu' to run on the CPU "
            "explicitly.")
    return torch.device("cuda", _card_index(topology))


# Milliseconds (host clock) of the parts of this process's last init() and
# last shutdown(): what an elastic reset spends where. init: "bootstrap"
# (the rendezvous), "backend" (the native core and the process group),
# "total"; shutdown: "coordinator" (the cycle thread), "backend" (the
# native core and the process group), "total".
LAST_TIMES = {"init": {}, "shutdown": {}}


@contextlib.contextmanager
def _timed(part, key):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        LAST_TIMES[part][key] = (time.perf_counter() - t0) * 1e3


def init(comm=None, process_sets=None, device=None):
    """Initialize the runtime (idempotent; reference: horovod_init).

    Args:
      comm: ignored; accepted for the reference's signature.
      process_sets: ``ProcessSet`` objects to register at startup, besides
        the global set (every rank passes the same list).
      device: where this rank computes. Default ``cuda:<local_rank>``;
        ``"cpu"`` runs on the CPU.
    """
    global _runtime
    with _init_lock:
        if _runtime is not None:
            return _runtime
        t0 = time.perf_counter()
        LAST_TIMES["init"] = {}
        from .runner import rendezvous as rdv
        rdv_cfg = rdv.rendezvous_config()
        if envparse.get_bool(envparse.ELASTIC) and rdv_cfg is not None:
            # Elastic workers are spawned WITHOUT rank env: ranks come from
            # the driver's latest membership version via the rendezvous
            # store, so a re-init after a reset lands in the new cohort
            # (reference: horovod/runner/elastic/rendezvous.py:28-60).
            with _timed("init", "bootstrap"):
                rdv.elastic_bootstrap()
            # Liveness lease: one beat thread for the whole process (a
            # worker mid-reset is alive; re-inits leave it running).
            from .runner import heartbeat
            heartbeat.start_worker_heartbeat()
        topology = Topology.from_env()
        spmd = (envparse.get_env(envparse.SIZE) is not None
                and envparse.get_env(envparse.RANK) is not None)
        if (spmd and (topology.size < 1
                      or not 0 <= topology.rank < topology.size)) \
                or (not spmd and topology.size != 1):
            raise ValueError(
                f"Invalid launcher topology: rank={topology.rank} "
                f"size={topology.size} (a multi-process job sets both "
                "RANK and SIZE)")
        if spmd and rdv_cfg is not None \
                and not envparse.get_str(envparse.PEERS, ""):
            # A static launcher job: the ranks exchange their native-core
            # listeners through the launcher's store (reference:
            # gloo_context.cc:150-228 bootstrapping from the driver).
            rdv.bootstrap_peers(topology)
        dev = _pick_device(device, topology)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # Auto-name counters restart with the runtime, so that ranks that
        # initialize again agree on generated names.
        from .ops.collectives import reset_auto_name_counters
        reset_auto_name_counters()
        from .backend import LoopbackBackend, make_spmd_backend
        if spmd:
            with _timed("init", "backend"):
                backend = make_spmd_backend(topology, dev)
            mode = MODE_SPMD
        else:
            mode, backend = MODE_SINGLE, LoopbackBackend()
        from . import process_sets as ps_mod
        from .coordinator import Coordinator
        runtime = Runtime(mode, topology, dev, backend)
        ps_mod._setup(runtime)
        for ps in process_sets or ():
            runtime.process_set_table.register(ps)
        runtime.coordinator = Coordinator(runtime)
        runtime.coordinator.start()
        timeline_path = envparse.get_str(envparse.TIMELINE, "")
        if timeline_path:
            from .timeline import Timeline
            if mode == MODE_SPMD:
                # The native core writes <path>.rank<r>; the Python plane
                # (the delegated data plane's spans) <path>.py.rank<r>.
                timeline_path += f".py.rank{topology.rank}"
            runtime.timeline = Timeline(
                timeline_path, mark_cycles=envparse.get_bool(
                    envparse.TIMELINE_MARK_CYCLES))
            runtime.timeline.start()
        # In a launcher job with metrics on, this rank's snapshot goes to
        # the launcher's KV store on a timer: its /metrics route serves the
        # cluster roll-up.
        if envparse.get_bool(envparse.METRICS) and rdv_cfg is not None:
            from .telemetry import MetricsPusher
            addr, port, token = rdv_cfg
            runtime.metrics_pusher = MetricsPusher(
                addr, port, token, topology.rank,
                interval_s=envparse.get_float(
                    envparse.METRICS_PUSH_INTERVAL, 5.0)).start()
        get_logger().info("init: %s mode rank=%d size=%d device=%s "
                          "backend=%s", mode, topology.rank, topology.size,
                          dev, backend.name)
        _runtime = runtime
        LAST_TIMES["init"]["total"] = (time.perf_counter() - t0) * 1e3
        return _runtime


def shutdown():
    """Tear down the runtime (reference: horovod_shutdown)."""
    global _runtime
    with _init_lock:
        if _runtime is None:
            return
        t0 = time.perf_counter()
        LAST_TIMES["shutdown"] = {}
        # The coordinator stops before the backend closes: its cycle thread
        # is the only one that drives the backend.
        with _timed("shutdown", "coordinator"):
            _runtime.coordinator.stop()
        if _runtime.timeline is not None:
            _runtime.timeline.stop()
        if _runtime.tracer is not None:
            # Flush and close this cohort's trace shard and push it to the
            # launcher's store; an elastic re-init opens a new shard under
            # the new membership version.
            _runtime.tracer.close()
            from . import tracing
            if tracing.active() is _runtime.tracer:
                tracing._set_active(None)
            _runtime.tracer = None
        if _runtime.metrics_pusher is not None:
            # A last push, so that shutdown-time counters reach the
            # launcher before the store loses this rank.
            _runtime.metrics_pusher.stop()
            _runtime.metrics_pusher = None
        _maybe_dump_metrics()
        with _timed("shutdown", "backend"):
            _runtime.backend.close()
        from . import process_sets
        process_sets._teardown(_runtime)
        _runtime._shutdown = True
        _runtime = None
        LAST_TIMES["shutdown"]["total"] = (time.perf_counter() - t0) * 1e3


def _maybe_dump_metrics():
    """Write a last JSON snapshot to ``HVDTPU_METRICS_DUMP`` (if set), the
    file the telemetry CLI's ``diff`` reads."""
    path = envparse.get_str(envparse.METRICS_DUMP, "")
    if not path or not envparse.get_bool(envparse.METRICS):
        return
    from . import telemetry
    try:
        with open(path, "w") as f:
            f.write(telemetry.render_json(metrics_snapshot(), indent=1))
    except OSError as exc:
        get_logger().warning("could not write metrics dump %s: %s",
                             path, exc)


def metrics_snapshot():
    """JSON-able snapshot of the metrics registry, with the rank, size and
    mode while the runtime is up. Its families are empty unless
    ``HOROVOD_TPU_METRICS`` is on."""
    from . import telemetry
    snap = telemetry.snapshot()
    if _runtime is not None and not _runtime._shutdown:
        snap["rank"] = _runtime.topology.rank
        snap["size"] = _runtime.topology.size
        snap["mode"] = _runtime.mode
    return snap


atexit.register(shutdown)


def is_initialized():
    return _runtime is not None


def runtime():
    if _runtime is None:
        raise NotInitializedError()
    return _runtime


def rank():
    return runtime().topology.rank


def size():
    return runtime().topology.size


def local_rank():
    return runtime().topology.local_rank


def local_size():
    return runtime().topology.local_size


def cross_rank():
    return runtime().topology.cross_rank


def cross_size():
    return runtime().topology.cross_size


def device():
    """The device this rank computes on."""
    return runtime().device


def is_homogeneous():
    """True when every host runs the same number of ranks (reference:
    horovod_is_homogeneous)."""
    topo = runtime().topology
    return topo.size == topo.local_size * topo.cross_size


# What this build of torch can run on (reference: horovod/common/basics.py
# *_built / *_enabled). The port's data plane is torch.distributed or the
# native core's TCP ring.
def mpi_built():
    import torch.distributed as dist
    return dist.is_available() and dist.is_mpi_available()


def mpi_enabled():
    return False


def mpi_threads_supported():
    return False


def gloo_built():
    import torch.distributed as dist
    return dist.is_available() and dist.is_gloo_available()


def gloo_enabled():
    return getattr(runtime().backend, "dist_backend", None) == "gloo"


def nccl_built():
    import torch.distributed as dist
    return dist.is_available() and dist.is_nccl_available()


def ddl_built():
    return False


def ccl_built():
    return False


def cuda_built():
    return torch.version.cuda is not None


def rocm_built():
    return torch.version.hip is not None
