"""Framework exceptions (port of ``horovod_tpu/exceptions.py``; the
reference's taxonomy, horovod/common/exceptions.py)."""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails.

    Recoverable via elastic mode, once that is ported: the training loop
    restores the last committed state and re-initializes (reference:
    horovod/common/elastic.py:151).
    """


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
