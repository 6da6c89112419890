"""Parallelism strategies over torch process groups (port of
``horovod_tpu/parallel/``).

Every strategy takes its mesh axis as a process group (or a 1-D
``DeviceMesh``); every data exchange is a ``torch.distributed`` collective
(NCCL on the card, gloo on the CPU) wrapped with its transpose
(``axis.py``), so that autograd differentiates through it.

- axis:            the collectives and their backwards (ppermute,
                   all_to_all, psum/pmean, vary_replicated, all_gather,
                   psum_scatter)
- mesh:            N-D mesh construction + axis bookkeeping (dp/fsdp/pp/sp/tp)
- ring_attention:  context parallelism — the flash kernels' LSE mode with
                   offsets, k/v chunks rotating over the axis by ppermute
- ulysses:         sequence parallelism via head-scatter all_to_all
- pipeline:        pipeline parallelism via microbatch streaming
- moe:             expert parallelism — top-k gating + all_to_all dispatch
- sharding:        the PartitionSpec rules (tp + fsdp) and ``shard_model``,
                   the TransformerLM run under them (the execution GSPMD
                   gives the rules in JAX)
- twod:            2D (data × tensor) ZeRO over a ("dp", "tp") mesh and its
                   planner-emitted elastic reshard
"""

from .mesh import AXIS_ORDER, MeshConfig, make_mesh  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .pipeline import (module_stage, pipeline_apply,  # noqa: F401
                       stack_stage_params)
from .moe import MoELayer, moe_apply  # noqa: F401
from .sharding import (  # noqa: F401
    transformer_param_rules, make_param_specs, shard_params,
    constrain, batch_spec, shard_model,
)
