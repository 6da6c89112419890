"""N-D mesh construction and axis bookkeeping (port of
``horovod_tpu/parallel/mesh.py``).

``MeshConfig`` is the JAX package's, as it is. ``make_mesh`` builds a
``torch.distributed.device_mesh.DeviceMesh`` named by ``AXIS_ORDER`` over
the job's ranks in rank order: ``mesh["sp"].get_group()`` (or
``mesh["sp"]`` itself) is the axis a strategy takes.

Axis convention (outer → inner, slowest → fastest wire):
  dp   — data parallelism (pure replication of params)
  fsdp — data parallelism with parameter sharding (ZeRO-3 style)
  pp   — pipeline stages
  sp   — sequence/context parallelism (ring attention / Ulysses)
  tp   — tensor parallelism (innermost: nearest neighbours)

``ep`` (expert parallelism) gets no axis of its own: experts shard over
the ('dp','fsdp') axes, see moe.py.
"""

import dataclasses

import torch.distributed as dist

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each parallelism axis; -1 on dp = "use remaining devices"."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        known = self.fsdp * self.pp * self.sp * self.tp
        dp = self.dp
        if dp == -1:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"fsdp*pp*sp*tp={known}")
            dp = n_devices // known
        if dp * known != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.pp}x{self.sp}x{self.tp} != "
                f"{n_devices} devices")
        return dataclasses.replace(self, dp=dp)

    @property
    def shape(self):
        return (self.dp, self.fsdp, self.pp, self.sp, self.tp)

    @property
    def data_axes(self):
        """Axes gradients are reduced over (batch is sharded over these)."""
        return ("dp", "fsdp")


def make_mesh(config=None):
    """The named mesh over every rank of the initialized process group, in
    rank order (rank r at the row-major position r of ``config.shape``), on
    CUDA devices over NCCL, else on the CPU. Every rank must call it: it
    forms one process group per axis slice."""
    from torch.distributed.device_mesh import init_device_mesh
    config = (config or MeshConfig()).resolve(dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, config.shape,
                            mesh_dim_names=AXIS_ORDER)
