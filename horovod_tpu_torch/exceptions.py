"""Framework exceptions (port of ``horovod_tpu/exceptions.py``; the
reference's taxonomy, horovod/common/exceptions.py). A recoverable
collective failure raises ``HorovodInternalError`` and a membership change
``HostsUpdatedInterrupt``; ``elastic.run`` catches both."""


# Process exit code a worker uses to request a fresh respawn of its slot
# (elastic exit-restart, elastic.py). Defined here so that the launcher and
# the driver import it without the elastic module.
RESTART_EXIT_CODE = 79

# Exit code of a graceful preemption hand-off: the worker caught SIGTERM,
# persisted its last commit at a commit boundary, and left. The elastic
# driver counts it as a membership change, not a failure.
PREEMPT_EXIT_CODE = 83


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails.

    Recoverable via elastic mode: the training loop restores the last
    committed state and re-initializes (reference:
    horovod/common/elastic.py:151).
    """


class HostsUpdatedInterrupt(Exception):
    """The set of participating hosts changed.

    The elastic driver publishes a new membership version; the worker
    raises this at the next commit boundary (reference:
    horovod/common/exceptions.py, horovod/common/elastic.py:57).
    """

    def __init__(self, skip_sync=False):
        super().__init__()
        self.skip_sync = skip_sync


class NotInitializedError(RuntimeError):
    """An API that requires ``init()`` was called before initialization."""

    def __init__(self, what="Collective operations"):
        super().__init__(
            f"{what} called before init(); call horovod_tpu_torch.init() "
            "first.")


class DuplicateNameError(ValueError):
    """Two in-flight tensors share a name within one process set (reference:
    horovod/common/common.h:229 DUPLICATE_NAME_ERROR, tensor_queue.cc)."""


class StalledTensorError(HorovodInternalError):
    """A named tensor was submitted by some ranks but not all within the
    stall-shutdown time (reference: horovod/common/stall_inspector.cc:26).
    A ``HorovodInternalError``, so that elastic recovery catches it like
    any other failed collective."""
