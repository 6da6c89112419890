"""Runtime singleton: topology, device, backend; init/shutdown (port of
``horovod_tpu/basics.py``).

The port runs the reference's execution model: one process per GPU, ranks
from the launcher's environment (the same ``HVDTPU_*``/``HOROVOD_*`` names
the JAX package reads, so one launcher serves both). Size 1 runs on a
loopback backend; larger jobs on ``torch.distributed`` (NCCL on CUDA, gloo
on the CPU).

Entry points run on the card: ``init()`` picks ``cuda:<local_rank>`` and
raises when there is no CUDA device, unless the caller asks for the CPU
with ``init(device="cpu")``.
"""

import atexit
import threading

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


class Runtime:
    """Owns topology, device, backend and the process-set table."""

    def __init__(self, topology, device, backend):
        self.topology = topology
        self.device = device
        self.backend = backend
        self.process_set_table = None   # attached by process_sets._setup


_runtime = None
_init_lock = threading.Lock()


def _pick_device(device, topology):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.init(): no CUDA device is available. The "
            "port runs on the GPU; pass device='cpu' to run on the CPU "
            "explicitly.")
    return torch.device("cuda", topology.local_rank)


def init(comm=None, process_sets=None, device=None):
    """Initialize the runtime (idempotent; reference: horovod_init).

    Args:
      comm: ignored; accepted for the reference's signature.
      process_sets: ``ProcessSet`` objects to register at startup, besides
        the global set (every rank passes the same list).
      device: where this rank computes. Default ``cuda:<local_rank>``;
        ``"cpu"`` runs on the CPU (gloo backend when the job has several
        ranks).
    """
    global _runtime
    with _init_lock:
        if _runtime is not None:
            return _runtime
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
        dev = _pick_device(device, topology)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        from .backend import LoopbackBackend, TorchDistBackend
        if topology.size > 1:
            backend = TorchDistBackend(topology, dev)
        else:
            backend = LoopbackBackend()
        from . import process_sets as ps_mod
        runtime = Runtime(topology, dev, backend)
        ps_mod._setup(runtime)
        for ps in process_sets or ():
            runtime.process_set_table.register(ps)
        get_logger().info("init: rank=%d size=%d device=%s backend=%s",
                          topology.rank, topology.size, dev, backend.name)
        _runtime = runtime
        return _runtime


def shutdown():
    """Tear down the runtime (reference: horovod_shutdown)."""
    global _runtime
    with _init_lock:
        if _runtime is None:
            return
        from . import process_sets
        process_sets._teardown(_runtime)
        _runtime.backend.close()
        _runtime = None


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
# *_built / *_enabled). The port's data plane is torch.distributed.
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
    return runtime().backend.name == "gloo"


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
