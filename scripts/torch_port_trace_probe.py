"""What a machine's torch offers the port's traced-program lint
(``horovod_tpu_torch/analysis/fx_lint.py``), and which frameworks it has.

    python scripts/torch_port_trace_probe.py

Prints the Python, torch and CUDA versions; whether ``tensorflow``,
``keras``, ``triton`` and ``transformers`` are installed and import; the
card's name and power limit; ``make_fx``'s signature. Then it traces,
with TorchDynamo disabled and on fake tensors (on the card if there is
one), a function in which custom ops with fake implementations stand for
a collective, the rank and a kernel launch, a ``torch.cond`` on the rank
guards a collective and a ``torch.while_loop`` runs one, and prints the
graph, each subgraph and, for each tensor a subgraph closes over, the
outer nodes that share its storage (how the lint follows a closure), and
the trace's seconds.
"""

import importlib
import importlib.util
import inspect
import subprocess
import sys
import time
import traceback

import torch
from torch.fx.experimental.proxy_tensor import make_fx


def report_environment():
    print("versions", sys.version.split()[0], torch.__version__,
          torch.version.cuda)
    for m in ("tensorflow", "keras", "triton", "transformers"):
        print("spec", m, importlib.util.find_spec(m) is not None)
    for m in ("tensorflow", "keras"):
        try:
            mod = importlib.import_module(m)
            print("import", m, getattr(mod, "__version__", "?"))
        except Exception as e:  # noqa: BLE001 - reported, not raised
            print("import", m, "FAILED", type(e).__name__, str(e)[:200])
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout)
    except OSError as e:
        print(e)
    print("make_fx", inspect.signature(make_fx))
    print("torch.while_loop", hasattr(torch, "while_loop"), "torch.cond",
          hasattr(torch, "cond"))


@torch.library.custom_op("hvdprobe::coll", mutates_args=())
def coll(x: torch.Tensor, op: str, axis: str, shape: list[int],
         site: str) -> torch.Tensor:
    raise RuntimeError("never runs")


@coll.register_fake
def _(x, op, axis, shape, site):
    return x.new_empty(shape)


@torch.library.custom_op("hvdprobe::rank", mutates_args=())
def rank(axis: str, site: str) -> torch.Tensor:
    raise RuntimeError("never runs")


@rank.register_fake
def _(axis, site):
    return torch.empty((), dtype=torch.int64)


@torch.library.custom_op("hvdprobe::kern", mutates_args=("outs",))
def kern(name: str, ins: list[torch.Tensor],
         outs: list[torch.Tensor]) -> None:
    raise RuntimeError("never runs")


@kern.register_fake
def _(name, ins, outs):
    return None


def site():
    f = sys._getframe(2)
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def psum(x, axis):
    return coll(x, "psum", axis, list(x.shape), site())


def fn(w, x):
    from torch._higher_order_ops.while_loop import while_loop
    i = rank("hvd", "s")
    j = i + 1
    o = torch.empty_like(x)
    kern("fwd", [x], [o])
    y = torch.cond(i == 0, lambda y: psum(y * j, "hvd"),
                   lambda y: y.clone(), (o @ w,))
    return while_loop(lambda c, y: c < j,
                      lambda c, y: (c + 1, psum(y, "hvd")),
                      (torch.zeros((), dtype=torch.int64), y))


def main():
    report_environment()
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.ones(4, 4, device=dev)
    w = torch.ones(4, 4, device=dev, requires_grad=True)
    t0 = time.time()
    try:
        with torch._dynamo.config.patch(disable=True):
            gm = make_fx(fn, tracing_mode="fake")(w, x)
        print(gm.graph)
        for name, m in gm.named_children():
            print(name, m.graph)
            for n in m.graph.nodes:
                if n.op == "get_attr":
                    c = getattr(m, n.target)
                    key = c.untyped_storage()._cdata
                    print("  const", n.target, [
                        k.name for k in gm.graph.nodes
                        if isinstance(k.meta.get("val"), torch.Tensor)
                        and k.meta["val"].untyped_storage()._cdata == key])
        print("trace ok", time.time() - t0)
    except Exception:  # noqa: BLE001 - reported, not raised
        traceback.print_exc()


if __name__ == "__main__":
    main()
