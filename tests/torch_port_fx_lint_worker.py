"""One rank of a launcher job of the port that runs ``tpu_compile(verify=True)``
on two modules over the world group, for tests/test_torch_port_fx_lint_job.py
(the CPU, gloo) and tests/test_torch_port_fx_lint_cuda.py (two GPUs, NCCL):

    python -m horovod_tpu_torch.runner.launch -np 2 python \\
        torch_port_fx_lint_worker.py OUT

- ``Guarded``: a ``torch.cond`` on the traced rank guards a ``psum``. Run
  eagerly, rank 0 would enter the psum alone and the job would hang; with
  ``verify=True`` every rank raises ``CollectiveLintError`` (HVD102) at
  its first call, before any collective is issued.
- ``Hoisted``: the same body with the ``psum`` before the ``cond``: the
  check finds nothing and the call runs; every rank's sum agrees.

Each rank writes ``OUT/r<rank>.json``: the guarded call's outcome, the
number of ``torch.distributed`` collectives and port submissions made
until it raised, and the hoisted call's results. ``PORT_TEST_DEVICE=cpu``
runs it on the CPU.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

DEV = os.environ.get("PORT_TEST_DEVICE", "cuda")
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "broadcast", "all_to_all_single", "batch_isend_irecv",
               "barrier", "all_gather")


class Guarded(torch.nn.Module):
    def forward(self, x):
        from horovod_tpu_torch.parallel import axis as ax
        world = dist.group.WORLD
        return {"out": torch.cond(ax.axis_index(world) == 0,
                                  lambda t: ax.psum(t, world),
                                  lambda t: t * 2, (x,))}


class Hoisted(torch.nn.Module):
    def forward(self, x):
        from horovod_tpu_torch.parallel import axis as ax
        world = dist.group.WORLD
        s = ax.psum(x * (ax.axis_rank(world) + 1), world)
        return {"sum": s,
                "out": torch.cond(ax.axis_index(world) == 0,
                                  lambda t: t * 2, lambda t: t * 3, (s,))}


def main():
    out_dir = sys.argv[1]
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import CollectiveLintError
    from horovod_tpu_torch.ops import collectives as c
    from horovod_tpu_torch.torch import tpu_compile
    hvd.init(device="cpu" if DEV == "cpu" else None)
    calls = []
    for name in COLLECTIVES:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        setattr(dist, name, counted)
    plain_submit = c._submit

    def submit(entry):
        calls.append(f"submit:{entry.name}")
        return plain_submit(entry)
    c._submit = submit

    res = {"rank": hvd.rank(), "backend": dist.get_backend()}
    x = torch.ones(4, device=hvd.device())
    try:
        tpu_compile(Guarded(), verify=True)(x=x)
        res["guarded"] = "ran"
    except CollectiveLintError as e:
        res["guarded"] = sorted({d.rule for d in e.diagnostics})
    res["calls_before_the_raise"] = list(calls)
    out = tpu_compile(Hoisted(), verify=True)(x=x)
    res["sum"] = out["sum"].tolist()
    res["out"] = out["out"].tolist()
    res["hoisted_calls"] = sorted(set(calls) - set(
        res["calls_before_the_raise"]))
    hvd.shutdown()
    with open(os.path.join(out_dir, f"r{res['rank']}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
