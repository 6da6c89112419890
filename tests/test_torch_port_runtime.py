"""Port runtime: the package imports neither JAX nor the JAX package,
entry points refuse to fall back to the CPU, and the size-1 runtime,
topology, knobs and reduction ids agree with the JAX package's."""

import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import _build, basics
from horovod_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_runtime():
    hvd.shutdown()
    rt = hvd.init(device="cpu")
    yield rt
    hvd.shutdown()


def test_import_pulls_in_no_jax_and_no_horovod_tpu():
    code = ("import sys, pkgutil, importlib, horovod_tpu_torch\n"
            "for m in pkgutil.walk_packages(horovod_tpu_torch.__path__, "
            "'horovod_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.')]\n"
            "print(bad)\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('horovod_tpu_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    bad, imported = out.stdout.strip().splitlines()
    assert bad == "[]"
    # The walk reached every module of the telemetry, tracing and serving
    # planes, the models' remat and the BERT model, the programmatic and
    # cluster launch, the migration and lease specs, the fleet plane, and
    # the offline analyzer (hvd-lint, hvd-sim, explain, perf, hvd-model)
    # and the runtime checkers (the sanitizer, the order guard).
    for mod in ("telemetry.core", "telemetry.exposition",
                "telemetry.aggregate", "telemetry.cli", "telemetry.spans",
                "tracing", "tracing.recorder", "tracing.clock",
                "tracing.merge", "tracing.analyze", "tracing.cli",
                "models._remat", "models.transformer", "models.resnet",
                "serving", "serving.kv_cache", "serving.model",
                "serving.scheduler", "serving.migration", "serving.router",
                "serving.worker", "serving.state", "serving.autoscale",
                "serving.metrics", "serving.cli", "runner.cluster",
                "runner.task_exec", "analysis.protocol.migration_spec",
                "analysis.protocol.lease_spec", "fleet", "fleet.ledger",
                "fleet.policy", "fleet.metrics", "fleet.actuators",
                "fleet.arbiter", "fleet.cli", "analysis.diagnostics",
                "analysis.ast_lint", "analysis.schedule",
                "analysis.simulate", "analysis.explain", "analysis.sarif",
                "analysis.baseline", "analysis.cli", "analysis.costmodel",
                "analysis.protocol.model", "analysis.protocol.machines",
                "analysis.protocol.cli", "analysis.sanitizer",
                "analysis.order_guard"):
        assert f"'horovod_tpu_torch.{mod}'" in imported, mod


def test_init_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    hvd.shutdown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    assert hvd.init(device="cpu").device == torch.device("cpu")
    hvd.shutdown()


def test_cuda_tensor_without_a_built_library_raises(monkeypatch, tmp_path):
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    tfa.reset_launches()
    with FakeTensorMode():
        q = torch.empty(2, 64, 64, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfa.attention_fwd(q, q, q, (0, 0, 64), 0.125, True)
    assert tfa.LAUNCHES["fwd"] == 0


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(tfa, "_library", lambda: pytest.fail("launched"))
    with FakeTensorMode():
        q = torch.empty(2, 64, 64, dtype=torch.bfloat16, device="cuda")
        cases = [
            (torch.empty(2, 64, 256, dtype=torch.bfloat16, device="cuda"),
             ValueError),
            (torch.empty(2, 64, 64, dtype=torch.float64, device="cuda"),
             TypeError),
            (torch.empty(2, 100, 64, dtype=torch.bfloat16, device="cuda"),
             ValueError),
            (torch.empty_strided((2, 64, 64), (64 * 128, 128, 1),
                                 dtype=torch.bfloat16, device="cuda"),
             ValueError),
        ]
        for bad, exc in cases:
            with pytest.raises(exc):
                tfa.attention_fwd(bad, bad, bad, (0, 0, 64), 0.125, True)
        for v in (torch.empty(2, 64, 64, dtype=torch.float16, device="cuda"),
                  torch.empty(2, 64, 64, dtype=torch.bfloat16)):
            with pytest.raises(ValueError):   # mixed dtype, mixed device
                tfa.attention_fwd(q, q, v, (0, 0, 64), 0.125, True)


def test_operations_before_init_raise():
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    with pytest.raises(hvd.NotInitializedError):
        hvd.allreduce(torch.ones(2))


def test_size_one_runtime_on_the_cpu(cpu_runtime):
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert cpu_runtime.backend.name == "loopback"
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                                     postscale_factor=0.5), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Average, prescale_factor=3.0),
                       3 * x)
    assert torch.equal(x, torch.arange(4.0))
    y = x.clone()
    assert hvd.allreduce_(y, prescale_factor=2.0) is y
    assert torch.equal(y, 2 * x)
    assert torch.equal(hvd.allgather(x), x)
    assert torch.equal(hvd.broadcast(x, root_rank=0), x)
    with pytest.raises(ValueError):
        hvd.broadcast(x, root_rank=1)
    assert hvd.broadcast_object({"a": [1, 2]}) == {"a": [1, 2]}
    assert hvd.allgather_object("x") == ["x"]
    hvd.barrier()
    assert hvd.global_process_set.size() == 1
    assert hvd.global_process_set.rank() == 0
    # Process sets are ported: a set must be registered before use, and
    # the global set's ranks cannot be registered twice.
    with pytest.raises(ValueError, match="not registered"):
        hvd.allreduce(x, process_set=hvd.ProcessSet([0]))
    with pytest.raises(ValueError, match="already exists"):
        hvd.add_process_set([0])


def test_broadcast_optimizer_state_round_trips(cpu_runtime):
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=0.1)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    before = {k: v.clone() for k, v in opt.state[p].items()}
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for k, v in opt.state[p].items():
        assert torch.equal(v, before[k])


def test_topology_from_env_matches_the_jax_package(monkeypatch):
    from horovod_tpu.basics import Topology as JTopology
    env = {"HVDTPU_RANK": "3", "HOROVOD_SIZE": "8", "HVDTPU_LOCAL_RANK": "1",
           "HOROVOD_TPU_LOCAL_SIZE": "2", "HVDTPU_CROSS_RANK": "1",
           "HVDTPU_CROSS_SIZE": "4"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = basics.Topology.from_env(), JTopology.from_env()
    assert vars(got) == vars(want) == {
        "rank": 3, "size": 8, "local_rank": 1, "local_size": 2,
        "cross_rank": 1, "cross_size": 4}


@pytest.mark.parametrize("env", [{"HVDTPU_RANK": "2", "HVDTPU_SIZE": "2"},
                                 {"HVDTPU_SIZE": "2"}])
def test_invalid_topology_raises(monkeypatch, env):
    hvd.shutdown()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="topology"):
        hvd.init(device="cpu")


def test_knobs_and_reduce_ops_match_the_jax_package():
    from horovod_tpu.ops import reduce_ops as jops
    from horovod_tpu.utils import envparse as jenv
    from horovod_tpu_torch.ops import reduce_ops as tops
    from horovod_tpu_torch.utils import envparse as tenv
    assert tenv._PREFIXES == jenv._PREFIXES
    # The port declares the knobs it reads, each under the JAX package's
    # name and default.
    assert set(tenv.KNOBS) == {
        "LOG_LEVEL", "ZERO", "ZERO_BUCKET_BYTES", "BRIDGE_FLASH", "FLASH_DROPOUT", "CYCLE_TIME",
        "FUSION_THRESHOLD", "CACHE_CAPACITY", "HIERARCHICAL_THRESHOLD",
        "CPU_OPERATIONS", "TIMELINE", "TIMELINE_MARK_CYCLES",
        "STALL_CHECK_DISABLE", "STALL_CHECK_TIME", "STALL_CHECK_TIME_SECONDS",
        "STALL_SHUTDOWN_TIME_SECONDS", "METRICS", "LEGACY_AUTO_NAMES",
        "ELASTIC", "ELASTIC_CHECK_INTERVAL", "START_TIMEOUT", "KV_RETRIES",
        "KV_BACKOFF", "KV_DEADLINE", "HEARTBEAT_INTERVAL",
        "HEARTBEAT_TIMEOUT", "SIGKILL_DEADLINE", "COMPRESSION",
        "COMPRESSION_THRESHOLD", "COMPRESSION_BLOCK",
        "COMPRESSION_ERROR_FEEDBACK", "SPARSE", "SPARSE_THRESHOLD",
        "SPARSE_EMA", "CONSISTENCY_CHECK", "CONSISTENCY_TIMEOUT",
        "COLLECTIVE_TIMEOUT", "CHECKPOINT_KEEP", "RESHARD_BUCKET_BYTES",
        "METRICS_PUSH_INTERVAL", "METRICS_SNAPSHOT", "METRICS_DUMP",
        "TRACE", "TRACE_DIR", "FLIGHT_RECORDER", "FLIGHT_RECORDER_EVENTS",
        "AUTOTUNE", "AUTOTUNE_LOG", "AUTOTUNE_FUSION_CANDIDATES_MIB",
        "AUTOTUNE_CYCLE_CANDIDATES_MS", "AUTOTUNE_BUCKET_CANDIDATES",
        "AUTOTUNE_WARMUP_CYCLES", "AUTOTUNE_CYCLES_PER_CANDIDATE",
        "AUTOTUNE_CACHE", "AUTOTUNE_SIGNATURE", "AUTOTUNE_SCORE",
        "AUTOTUNE_CONFIRM_CYCLES", "AUTOTUNE_BUCKET_BYTES_CANDIDATES_MIB",
        "AUTOTUNE_COMPRESSION_CANDIDATES",
        "AUTOTUNE_COMPRESSION_THRESHOLD_CANDIDATES",
        "AUTOTUNE_ZERO_BUCKET_CANDIDATES_MIB", "COSTMODEL",
        "COSTMODEL_TABLE", "PERF_TARGET_RANKS", "LINT_BASELINE", "CHAOS", "CHAOS_LOG", "DRIVER_JOURNAL",
        "DRIVER_JOURNAL_SNAPSHOT_EVERY", "DRIVER_STANDBY_ADDRS",
        "DRIVER_LEASE_INTERVAL", "DRIVER_LEASE_TIMEOUT", "DRIVER_PORT",
        "SERVING_MAX_BATCH_TOKENS", "SERVING_KV_PAGE_SIZE",
        "SERVING_KV_PAGES", "SERVING_QUEUE_LIMIT", "SERVING_SCALE_UP_DEPTH",
        "SERVING_DRAIN_TIMEOUT", "SERVING_SLO_P99",
        "SERVING_MIGRATE_RETRIES", "SERVING_MIGRATE_DEADLINE",
        "SERVING_MIGRATE_MAX_BYTES", "FLEET_MIN_TRAIN_SLOTS",
        "FLEET_MIN_SERVE_SLOTS", "FLEET_WINDOW", "FLEET_COOLDOWN",
        "FLEET_EBB_IDLE_S", "FLEET_TICK_S", "SANITIZE", "ORDER_CHECK",
        "ORDER_CHECK_RECORD", "ORDER_CHECK_INTERVAL"}
    for name, knob in tenv.KNOBS.items():
        assert getattr(tenv, name) == name
        assert knob["default"] == jenv.KNOBS[name]["default"]
    for name in ("RANK", "SIZE", "LOCAL_RANK", "LOCAL_SIZE", "CROSS_RANK",
                 "CROSS_SIZE", "PEERS", "RENDEZVOUS_ADDR", "RENDEZVOUS_PORT",
                 "WORKER_ID", "ELASTIC_VERSION", "JOB_TOKEN",
                 "RENDEZVOUS_ADDRS"):
        assert getattr(tenv, name) == getattr(jenv, name)
    for name in ("Average", "Sum", "Adasum", "Min", "Max", "Product"):
        op = getattr(tops, name)
        assert op == getattr(jops, name)
        assert tops.op_name(op) == jops.op_name(op)


def test_smoke_kernel_check_rejects_a_lost_tile(monkeypatch):
    # chip_smoke.py's kernel-vs-plain comparison passes one-ulp bf16
    # differences and fails an output that lost one tile's contribution.
    import math
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)

    def fail(msg):
        raise AssertionError(msg)
    monkeypatch.setattr(chip_smoke, "fail", fail)
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 256, 64, generator=gen).bfloat16()
               for _ in range(3))
    scale = 1 / math.sqrt(64)
    o, _ = tfa.attention_fwd_plain(q, k, v, (0, 0, 256), scale, True)
    o32, _ = tfa.attention_fwd_plain(q.float(), k.float(), v.float(),
                                     (0, 0, 256), scale, True)
    chip_smoke.compare("bf16 vs fp32", o, o32.bfloat16(), tol)
    lost, _ = tfa.attention_fwd_plain(q, k, v, (0, 0, 192), scale, True)
    with pytest.raises(AssertionError, match="disagrees"):
        chip_smoke.compare("lost tile", lost, o, tol)
