"""Horovod's PyTorch API of the port (``horovod_tpu_torch.torch``) against
the JAX package's (``horovod_tpu.torch``) at size 1, in this process, where
the JAX package's binding runs its single-process path: the same calls give
the same values, types, dtypes and in-place behaviour. Also: the mode not
ported yet raises with its ROADMAP item, the reduction options (compression,
Adasum, sparse allreduce) run at size 1, the optimizer wrapper's checks,
an LR scheduler built before wrapping, the port's modules import no JAX,
and ``examples/pytorch_mnist.py`` runs on the port, in one process and in
a 2-rank gloo job.
"""

import os
import pkgutil
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import horovod_tpu_torch
import horovod_tpu_torch.torch as pt
import torch_port_launch
import torch_port_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "pytorch_mnist.py")


@pytest.fixture
def both(hvd):
    import horovod_tpu.torch as ref
    pt.shutdown()
    pt.init(device="cpu")
    yield ref, pt
    pt.shutdown()


@pytest.fixture
def port():
    pt.shutdown()
    pt.init(device="cpu")
    yield pt
    pt.shutdown()


def _x(dtype=torch.float32):
    return (torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5).to(dtype)


def _same(a, b):
    """Same type, and for tensors the same dtype, device, shape and values
    (recursively through tuples and lists)."""
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and a.shape == b.shape
                and torch.equal(a, b))
    return type(a) is type(b) and a == b


CALLS = {
    "allreduce": lambda m, x: m.allreduce(x),
    "allreduce_sum_scaled": lambda m, x: m.allreduce(
        x, op=m.Sum, prescale_factor=2.0, postscale_factor=0.25),
    "allreduce_average_kwarg": lambda m, x: m.allreduce(x, average=False),
    "allreduce_async": lambda m, x: m.synchronize(m.allreduce_async(x)),
    "allreduce_bf16": lambda m, x: m.allreduce(x.bfloat16(), op=m.Sum),
    "allreduce_int": lambda m, x: m.allreduce(x.long(), op=m.Sum),
    "grouped_allreduce": lambda m, x: m.grouped_allreduce([x, 2 * x]),
    "grouped_allreduce_async": lambda m, x: m.synchronize(
        m.grouped_allreduce_async([x, 2 * x], op=m.Sum,
                                  prescale_factor=3.0)),
    "allgather": lambda m, x: m.allgather(x),
    "allgather_async": lambda m, x: m.synchronize(m.allgather_async(x)),
    "grouped_allgather": lambda m, x: m.grouped_allgather([x, x[:1]]),
    "broadcast": lambda m, x: m.broadcast(x, 0),
    "broadcast_async": lambda m, x: m.synchronize(m.broadcast_async(x, 0)),
    "alltoall": lambda m, x: m.alltoall(x),
    "alltoall_splits": lambda m, x: m.alltoall(x, splits=[3]),
    "alltoall_async_splits": lambda m, x: m.synchronize(
        m.alltoall_async(x, splits=[3])),
    "reducescatter": lambda m, x: m.reducescatter(x),
    "grouped_reducescatter": lambda m, x: m.grouped_reducescatter(
        [x, 2 * x], op=m.Sum),
    "join": lambda m, x: m.join(),
    "barrier": lambda m, x: m.barrier(),
    "broadcast_object": lambda m, x: m.broadcast_object({"a": [1, 2]}),
    "allgather_object": lambda m, x: m.allgather_object(("x", 3)),
    "topology": lambda m, x: (m.rank(), m.size(), m.local_rank(),
                              m.local_size(), m.cross_rank(),
                              m.cross_size(), m.is_initialized(),
                              m.is_homogeneous()),
    "reduce_ops": lambda m, x: (m.Average, m.Sum, m.Adasum, m.Min, m.Max,
                                m.Product),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_same_result_as_the_jax_package(both, call):
    ref, port = both
    x = _x()
    want = CALLS[call](ref, x.clone())
    got = CALLS[call](port, x)
    assert _same(got, want), (got, want)
    assert torch.equal(x, _x())   # the plain spellings leave x alone


IN_PLACE = {
    "allreduce_": lambda m, t: m.allreduce_(t[0], prescale_factor=3.0),
    "allreduce_async_": lambda m, t: m.synchronize(
        m.allreduce_async_(t[0], postscale_factor=0.5)),
    "grouped_allreduce_": lambda m, t: m.grouped_allreduce_(
        t, prescale_factor=2.0),
    "grouped_allreduce_async_": lambda m, t: m.synchronize(
        m.grouped_allreduce_async_(t, op=m.Sum, postscale_factor=4.0)),
    "broadcast_": lambda m, t: m.broadcast_(t[0], 0),
    "broadcast_async_": lambda m, t: m.synchronize(
        m.broadcast_async_(t[0], 0)),
}


@pytest.mark.parametrize("call", sorted(IN_PLACE))
def test_in_place_spellings_write_back_as_the_jax_package(both, call):
    ref, port = both
    mine, theirs = [_x(), 2 * _x()], [_x(), 2 * _x()]
    got = IN_PLACE[call](port, mine)
    want = IN_PLACE[call](ref, theirs)
    assert _same(got, want)
    assert _same(mine, theirs)
    # The result is the input itself.
    if isinstance(got, list):
        assert all(g is t for g, t in zip(got, mine))
    else:
        assert got is mine[0]


def test_poll_is_true_at_once_at_size_one(port):
    # Every collective goes through the coordinator's cycle thread, also at
    # size 1: poll never blocks, and turns True once the cycle has run the
    # operation, without a synchronize.
    import time
    h = port.allreduce_async(_x())
    assert isinstance(port.poll(h), bool)
    deadline = time.monotonic() + 30
    while not port.poll(h):
        assert time.monotonic() < deadline, "the cycle never ran the op"
        time.sleep(0.001)
    assert port.poll(h) is True
    assert torch.equal(port.synchronize(h), _x())


def test_parameter_and_optimizer_broadcasts_return_none(both):
    ref, port = both
    model = torch.nn.Linear(3, 2)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for m in (ref, port):
        assert m.broadcast_parameters(model.state_dict(), root_rank=0) is None
        assert m.broadcast_parameters(model.named_parameters(), 0) is None
        assert m.broadcast_optimizer_state(opt, root_rank=0) is None
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def test_every_public_name_of_the_jax_package_binding():
    import horovod_tpu.torch as ref
    names = {n for n in dir(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), types.ModuleType)}
    names |= {"SyncBatchNorm", "elastic"}
    missing = []
    for name in sorted(names):
        try:
            getattr(pt, name)
        except AttributeError:
            missing.append(name)
    assert not missing
    from horovod_tpu_torch.torch.sync_batch_norm import SyncBatchNorm
    assert pt.SyncBatchNorm is SyncBatchNorm
    # hvd.elastic is ported: the reference's surface of the submodule.
    import horovod_tpu.torch.elastic as ref_elastic
    public = {n for n in dir(ref_elastic) if not n.startswith("_")
              and not isinstance(getattr(ref_elastic, n), types.ModuleType)}
    assert public <= set(dir(pt.elastic))


@pytest.mark.parametrize("call,item", [
    (lambda m: __import__("horovod_tpu_torch.tensorflow", fromlist=["x"])
     .tpu_compile(lambda t: t, example_inputs=(np.arange(3.0),))
     (np.arange(3.0)), "16b"),
])
def test_modes_not_ported_raise_with_their_roadmap_item(port, call, item):
    # metrics_snapshot raised here (item 13) until the telemetry plane was
    # ported, the bridge's verifier (item 15) until the fx lint was, the
    # TensorFlow bridge (item 16b) until it was: each now runs.
    out = call(port)
    np.testing.assert_array_equal(out.numpy(), np.arange(3.0))
    compiled = port.tpu_compile(torch.nn.Linear(2, 2), verify=True)
    compiled(input=torch.ones(1, 2))
    assert compiled._verified == {(False, False, ("input",))}


def test_metrics_snapshot_is_the_jax_package_s(port, hvd, monkeypatch):
    import horovod_tpu.torch as ref
    from horovod_tpu.telemetry import core as jcore
    from horovod_tpu_torch.telemetry import core as tcore
    for core in (jcore, tcore):
        monkeypatch.setattr(core, "_ENABLED", None)
    monkeypatch.setenv("HOROVOD_TPU_METRICS", "0")
    snaps = [ref.metrics_snapshot(), port.metrics_snapshot()]
    assert [s["families"] for s in snaps] == [{}, {}]
    assert snaps[1]["rank"] == 0 and snaps[1]["size"] == 1 and \
        snaps[1]["mode"] == "single"
    assert set(snaps[0]) == set(snaps[1])


def _sgd():
    return torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1)


def _plain_int8(x):
    from horovod_tpu_torch.compression import codecs
    return codecs.quantized_allreduce_plain(x[None], "int8", 256)


@pytest.mark.parametrize("call,want", [
    # Cast compressors: exact on these small integers.
    (lambda m: m.allreduce(_x(), compression=m.Compression.fp16), _x),
    (lambda m: m.allreduce(_x(), compression=m.Compression.bf16), _x),
    # A wire codec runs both legs of the quantized pipeline at one rank.
    (lambda m: m.synchronize(m.allreduce_async_(
        _x(), compression=m.Compression.int8)), lambda: _plain_int8(_x())),
    (lambda m: m.allreduce(_x(), op=m.Adasum), _x),
    (lambda m: m.sparse_allreduce_async(_x().to_sparse()).wait().to_dense(),
     _x),
    (lambda m: type(m.DistributedOptimizer(
        _sgd(), compression=m.Compression.bf16)).__name__,
     lambda: "_Distributed"),
    (lambda m: type(m.DistributedOptimizer(_sgd(), op=m.Adasum)).__name__,
     lambda: "_Distributed"),
])
def test_reduction_options_run_at_size_one(port, call, want):
    # The modes this test's predecessor expected to raise (compression,
    # Adasum, sparse allreduce) are ported.
    got = call(port)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.float32 and torch.equal(got, want())
        assert not torch.equal(_plain_int8(_x()), _x())
    else:
        assert got == want()


@pytest.mark.parametrize("profile", [False, True])
def test_start_and_stop_timeline_write_a_chrome_trace(port, tmp_path,
                                                      profile):
    # The timeline is ported: collectives between start and stop appear
    # as begin/end pairs on their tensor's lane; with a profiler directory
    # a torch.profiler trace is written beside it.
    import json
    path = tmp_path / "timeline.json"
    prof = tmp_path / "prof" if profile else None
    port.start_timeline(str(path), jax_profiler_dir=prof and str(prof))
    port.allreduce(_x(), name="tl.a")
    port.broadcast(_x(), 0, name="tl.b")
    port.stop_timeline()
    events = json.loads(path.read_text())
    by = {(e["args"]["tensor"], e["name"], e["ph"]) for e in events}
    assert {("tl.a", "FUSED_ALLREDUCE", "B"), ("tl.a", "FUSED_ALLREDUCE", "E"),
            ("tl.b", "BROADCAST", "B"), ("tl.b", "BROADCAST", "E")} <= by
    if profile:
        (trace,) = prof.iterdir()
        assert "traceEvents" in json.loads(trace.read_text())



def test_compression_none_is_accepted(port):
    out = port.allreduce(_x(), compression=port.Compression.none)
    assert torch.equal(out, _x())


def test_double_wrap_and_uncovered_parameters_raise(port):
    model = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.Linear(3, 1))
    opt = port.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    with pytest.raises(ValueError, match="already wrapped"):
        port.DistributedOptimizer(opt)
    with pytest.raises(ValueError, match="does not cover"):
        port.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model[0].named_parameters())


def test_lr_scheduler_built_before_wrapping_still_steps(port):
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    opt = port.DistributedOptimizer(opt,
                                    named_parameters=model.named_parameters())
    before = model.weight.detach().clone()
    with warnings.catch_warnings():
        # torch warns when the scheduler steps before the optimizer did.
        warnings.simplefilter("error")
        model(torch.ones(2, 3)).sum().backward()
        opt.step()
        sched.step()
    assert not torch.equal(model.weight, before)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)


def test_size_one_optimizer_registers_no_hooks(port):
    model = torch.nn.Linear(3, 1)
    opt = port.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                    lr=0.1))
    assert opt._hvd_sync_disabled and not opt._hvd_hook_handles
    model(torch.ones(2, 3)).sum().backward()
    grad = model.weight.grad.clone()
    opt.step()
    torch.testing.assert_close(model.weight.grad, grad)


def test_sync_batch_norm_is_batch_norm_at_size_one(port):
    from horovod_tpu_torch.torch.sync_batch_norm import convert_sync_batchnorm
    ref = torch.nn.BatchNorm2d(3)
    model = convert_sync_batchnorm(
        torch.nn.Sequential(torch.nn.BatchNorm2d(3)))
    assert isinstance(model[0], pt.SyncBatchNorm)
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(model(x), ref(x))
    torch.testing.assert_close(model[0].running_var, ref.running_var)


def test_every_port_module_imports_no_jax():
    names = [m.name for m in pkgutil.walk_packages(
        horovod_tpu_torch.__path__, "horovod_tpu_torch.")]
    assert "horovod_tpu_torch.torch.sync_batch_norm" in names
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pytorch_mnist_example_runs_on_the_port(port, capsys):
    scope = {"__name__": "example"}
    exec(compile(torch_port_worker.example_source(EXAMPLE), EXAMPLE,
                 "exec"), scope)
    scope["main"]()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "done"
    losses = [float(line.split("loss=")[1]) for line in lines
              if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_pytorch_mnist_example_runs_on_two_ranks(tmp_path):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = torch_port_launch.free_port()
    procs = [ctx.Process(target=torch_port_worker.run_example,
                         args=(r, 2, str(tmp_path), port, queue, EXAMPLE))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    for rank in range(2):
        assert isinstance(results[rank], tuple), results[rank]
    (lines0, sums0), (lines1, sums1) = results[0], results[1]
    assert lines0[-1] == "done" and lines1 == []
    # Same start (broadcast) and the same averaged gradients on both ranks:
    # the models end equal.
    assert sums0 == sums1
