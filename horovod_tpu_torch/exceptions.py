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


class StalledTensorError(RuntimeError):
    """A named tensor was submitted by some ranks but not all within the
    stall-shutdown time (reference: horovod/common/stall_inspector.cc:26).
    A plain ``RuntimeError``, as in the JAX package: a rank that never
    submits a name is a program bug, which elastic recovery must surface.
    Turning a stuck collective into a restore-and-reset is the watchdog's
    ``CollectiveAbortError`` (``HVDTPU_COLLECTIVE_TIMEOUT``)."""


class CollectiveAbortError(HorovodInternalError):
    """The stuck-collective watchdog aborted every in-flight operation
    after ``HVDTPU_COLLECTIVE_TIMEOUT`` (``guardian.py``; the enforcement
    analog of the reference's stall inspector, horovod/common/
    stall_inspector.cc). The message carries the watchdog's diagnostic:
    which operations stalled and which ranks never submitted them. A
    ``HorovodInternalError`` on purpose: under elastic training the abort
    becomes a restore-and-reset instead of a hang or a job death."""


class CollectiveMismatchError(RuntimeError):
    """Ranks submitted the same named collective with divergent metadata
    (kind, op, dtype, shapes, process set, scale factors, codec, shard),
    found by the pre-dispatch consistency check
    (``HVDTPU_CONSISTENCY_CHECK``; ``guardian.py``; the reference
    controller's message-table mismatch errors, horovod/common/
    controller.cc). Not a ``HorovodInternalError``: the divergence is a
    deterministic program bug, which elastic recovery must surface rather
    than retry. ``divergences`` holds ``(rank, field, theirs, ours)``
    tuples."""

    def __init__(self, message, divergences=()):
        super().__init__(message)
        self.divergences = list(divergences)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check (truncated, checksum
    mismatch, foreign format) and no intact fallback was available
    (``checkpoint.py``)."""


class SubmissionOrderError(RuntimeError):
    """Ranks submitted collectives in divergent orders (or with divergent
    auto-generated names), detected by the opt-in runtime order guard
    (``HOROVOD_TPU_ORDER_CHECK=1``; analysis/order_guard.py). The static
    analog is hvd-lint rule HVD203.

    Not a ``HorovodInternalError``: the divergence is a deterministic
    program bug, so the elastic restore loop (which retries internal
    errors) must surface it instead of retrying into it again."""


class LockOrderError(RuntimeError):
    """hvd-sanitize detected a lock-acquisition-order cycle: acquiring
    this lock while holding another reverses an order recorded earlier
    in the process, so two threads interleaving the two paths can
    deadlock (ABBA). The message carries both acquisition stacks
    (``HVDTPU_SANITIZE``; analysis/sanitizer.py).

    Not a ``HorovodInternalError``, for the reason
    ``SubmissionOrderError`` is not one."""


class ChaosInjectedError(RuntimeError):
    """A chaos ``fail`` injection fired at a point with no more specific
    error type (``HVDTPU_CHAOS``; ``chaos/``). KV points raise transport
    errors and collective points raise ``HorovodInternalError`` instead,
    so recovery paths see exactly the exceptions real faults produce."""


class CollectiveLintError(ValueError):
    """Static analysis (hvd-lint) found error-severity collective hazards
    and ``verify=`` asked for enforcement. ``self.diagnostics`` carries
    the structured findings (analysis/diagnostics.py)."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        lines = "\n".join(d.format() for d in self.diagnostics)
        super().__init__(
            f"hvd-lint found {len(self.diagnostics)} collective-"
            f"correctness finding(s):\n{lines}")
