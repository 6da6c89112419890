"""Memory-bounded (mesh, layout) → (mesh, layout) redistribution (port of
``horovod_tpu/resharding/``).

Describe both sides as :class:`Spec`, call :func:`plan_redistribution`,
and execute the resulting :class:`Program` in one process
(:func:`execute_host`), over one axis's process group
(:func:`make_jit_executor`), or over a group holding both cohorts
(:func:`execute_group`, what a job of one process per GPU needs).
Programs are chunked to ``HVDTPU_RESHARD_BUCKET_BYTES``, priced by the
α–β cost model and carry guardian digests; ``Program.prove`` checks a
program deadlock-free and digest-consistent under the symbolic simulator
(``analysis.simulate``).
"""

from .spec import (Interval, Replicated, Sharded, Spec, ZeroFlat,
                   leaf_offsets, replicated_spec, tree_meta_of,
                   zero_flat_spec)
from .planner import (Copy, DEFAULT_RESHARD_BUCKET_BYTES, PlanError,
                      Program, Step, check_streams,
                      plan_redistribution)
from .execute import (MemoryLedger, buffers_of_tree, execute_group,
                      execute_host, make_jit_executor, reader_for_buffers)

__all__ = [
    "Interval", "Replicated", "Sharded", "Spec", "ZeroFlat",
    "leaf_offsets", "replicated_spec", "tree_meta_of",
    "zero_flat_spec", "Copy", "DEFAULT_RESHARD_BUCKET_BYTES",
    "PlanError", "Program", "Step", "check_streams",
    "plan_redistribution", "MemoryLedger", "buffers_of_tree",
    "execute_host", "make_jit_executor", "reader_for_buffers",
    "execute_group",
]
