"""The gloo jobs of tests/test_torch_port_collectives.py over NCCL, one
rank per GPU, with every tensor on the rank's card (worker body:
tests/torch_port_worker.py): the same checks, plus one that launches,
polls and synchronizes async allreduces with the host allowed to wait for
nothing; needs 3 GPUs. And the rank-order and hook-order job of
tests/test_torch_port_spmd.py over NCCL (tests/torch_port_spmd_worker.py
with ``PORT_TEST_DEVICE=cuda``), and elastic jobs over NCCL through the
port's launcher whose slot 1 or slot 0 is killed
(tests/torch_port_elastic_worker.py, a tiny TransformerLM under
``TorchState``): the survivor aborts its communicators, resets in process
on its own card (the respawned slot takes its slot's card) and finishes
with the parameters of an uninterrupted run; each needs 2 GPUs. And the
``reduce`` job of tests/test_torch_port_spmd.py over NCCL at 2 and 4
ranks: the catch-all int8 and fp8 quantized pipeline against
``quantized_allreduce_plain`` of the stacked inputs, Adasum (staged
through pinned host memory) against the VHDD oracle, sparse gathers
against the dense sum; needs 4 GPUs. And the ZeRO-1 jobs of
tests/test_torch_port_zero.py over NCCL at 2 and 4 ranks
(tests/torch_port_zero_worker.py): the sharded update against the
replicated one (bit-identical at 2 ranks, within 1e-6 at 4), state bytes
1/n of the replicated, the codec legs' residuals, the version bump, a
plan mismatch failing in the negotiation, and the full-width, full-depth
TransformerLM's peak allocated memory per rank below the replicated
run's; needs 4 GPUs. Each skips elsewhere:

    python -m pytest --noconftest -m cuda tests/test_torch_port_nccl.py
"""

import pytest
import torch

from test_torch_port_collectives import CHECKS, SET_CHECKS, _run_job
from test_torch_port_spmd import (_finish, _ok, _port_job, _read,
                                  check_adasum, check_catch_all,
                                  dense_sparse_sum)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpus():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 3:
        pytest.skip("needs 3 CUDA devices (a multi-GPU machine)")


@pytest.fixture(scope="module")
def job(gpus):
    return _run_job(2, CHECKS + ["no_host_wait"], device="cuda")


@pytest.fixture(scope="module")
def set_job(gpus):
    return _run_job(3, SET_CHECKS, device="cuda")


@pytest.mark.parametrize("check", CHECKS + ["no_host_wait"])
def test_two_rank_nccl_job(job, check):
    assert all(job[rank][check] for rank in range(2)), \
        {rank: job[rank][check] for rank in range(2)}


@pytest.mark.parametrize("check", SET_CHECKS)
def test_three_rank_nccl_process_set_job(set_job, check):
    assert all(set_job[rank][check] for rank in range(3)), \
        {rank: set_job[rank][check] for rank in range(3)}


@pytest.fixture(scope="module")
def order_job(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (a multi-GPU machine)")
    out = tmp_path_factory.mktemp("nccl-order")
    procs = _port_job("main", "gloo", 2, out, {"PORT_TEST_DEVICE": "cuda"})
    return _ok(_read(out, 2, _finish(procs)))


@pytest.mark.parametrize("check", ["rank_order", "hook_step_equals_full_batch",
                                   "duplicate"])
def test_rank_and_hook_order_over_nccl(order_job, check):
    assert all(order_job[r][check] for r in range(2))
    assert order_job[0]["hook_order"] != order_job[1]["hook_order"]


@pytest.fixture(scope="module")
def elastic_jobs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    from test_torch_port_elastic import _Job
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("nccl-elastic")
    env = {"ELASTIC_TEST_EPOCHS": 5, "PORT_TEST_DEVICE": "cuda"}
    started = {
        wid: _Job(root, f"kill{wid[-1]}", "transformer", [["localhost:2"]],
                  {**env, "ELASTIC_TEST_KILL_WORKER": wid,
                   "ELASTIC_TEST_KILL_EPOCH": 3})
        for wid in ("localhost:1", "localhost:0")}
    started["ref"] = _Job(root, "ref", "transformer", [["localhost:2"]], env)
    return {name: job.finish() for name, job in started.items()}


@pytest.mark.parametrize("killed", ["localhost:1", "localhost:0"])
def test_nccl_elastic_job_survives_a_killed_rank(elastic_jobs, killed):
    import numpy as np
    job, ref = elastic_jobs[killed], elastic_jobs["ref"]
    for j in (job, ref):
        assert j["rc"] == 0, (j["log"], j["launcher"][-4000:])
        assert sum(" DONE " in line for line in j["log"].splitlines()) == 2
    assert "KILLED step=3" in job["log"]
    assert "aborting this rank's NCCL communicators" in job["launcher"]
    # Each slot computes on its own card, whatever rank it ends with.
    done = {line.split()[0]: line for line in job["log"].splitlines()
            if " DONE " in line}
    assert "rank=0" in done[{"localhost:1": "localhost:0",
                             "localhost:0": "localhost:1"}[killed]], done
    for slot in ("0", "1"):
        assert f"device=cuda:{slot}" in done[f"localhost:{slot}"], done
    got = np.load(job["path"] + ".params.npz")
    want = np.load(ref["path"] + ".params.npz")
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


REDUCE_JOBS = [("int8", 2), ("int8", 4), ("fp8", 2)]


@pytest.fixture(scope="module")
def reduce_jobs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a multi-GPU machine)")
    import numpy as np
    done = {}
    for wire, size in REDUCE_JOBS:
        out = tmp_path_factory.mktemp(f"nccl-reduce-{wire}-{size}")
        procs = _port_job("reduce", "gloo", size, out, {
            "PORT_TEST_DEVICE": "cuda", "HVDTPU_SPARSE": "gather",
            "HVDTPU_COMPRESSION": f"sp*=none;grad.sp*=none;{wire}"})
        job = _read(out, size, _finish(procs))
        _ok(job)
        done[wire, size] = (job, [dict(np.load(out / f"r{r}.npz"))
                                  for r in range(size)])
    return done


@pytest.mark.parametrize("wire,size", REDUCE_JOBS)
def test_nccl_catch_all_quantized_allreduce_equals_the_plain_pipeline(
        reduce_jobs, wire, size):
    check_catch_all(reduce_jobs[wire, size][1], size, wire)


@pytest.mark.parametrize("size", [2, 4])
def test_nccl_adasum_staged_through_the_host_equals_vhdd(reduce_jobs, size):
    check_adasum(reduce_jobs["int8", size][1], size)


@pytest.mark.parametrize("size", [2, 4])
def test_nccl_sparse_gathers_equal_the_dense_sum(reduce_jobs, size):
    import numpy as np
    job, got = reduce_jobs["int8", size]
    dense, _ = dense_sparse_sum(size)
    for r in range(size):
        assert job["res"][r]["sparse_paths"]["gather"] == 4
        assert job["res"][r]["sparse_train_equal"]
        assert job["res"][r]["sparse_hook_equal"]
        for key, div in (("sp_sum", 1), ("sp_avg", size), ("sp_bind", size),
                         ("spq_rows", 1)):
            np.testing.assert_allclose(got[r][key], dense / div, rtol=1e-6,
                                       atol=1e-6)


ZERO_SIZES = (2, 4)


@pytest.fixture(scope="module")
def zero_jobs(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (a multi-GPU machine)")
    import numpy as np
    import torch_port_launch
    from horovod_tpu_torch import _build
    from test_torch_port_zero import _zero_job
    # The workers of the memory jobs load the flash kernels: build them
    # once, before they start.
    _build.build(["flash_attention"])
    torch_port_launch.build_port_core()
    done = {}
    for mode, sizes in (("zero", ZERO_SIZES), ("memory", ZERO_SIZES),
                        ("mismatch", (2,))):
        for size in sizes:
            out = tmp_path_factory.mktemp(f"nccl-zero-{mode}-{size}")
            procs = _zero_job(mode, "gloo", size, out,
                              {"PORT_TEST_DEVICE": "cuda"})
            job = _read(out, size, _finish(procs))
            done[mode, size] = _ok(job)
            if mode == "zero":
                done["npz", size] = [dict(np.load(out / f"r{r}.npz"))
                                     for r in range(size)]
    # The measured numbers, for a run with -s.
    for size in ZERO_SIZES:
        diffs = [d for r in range(size)
                 for d in done["zero", size][r]["diffs"].values()]
        mem = done["memory", size]
        print(f"[zero card] n={size}: ZeRO against replicated: all equal "
              f"{all(d['equal'] for d in diffs)}, max |difference| "
              f"{max(d['max_abs'] for d in diffs):.3e}; per rank peak "
              f"allocated GiB replicated/ZeRO "
              + ", ".join(f"{m['replicated.peak'] / 2 ** 30:.2f}/"
                          f"{m['zero.peak'] / 2 ** 30:.2f}"
                          for m in mem.values())
              + "; state bytes ZeRO/replicated "
              + ", ".join(f"{m['zero.state_bytes'] / m['replicated.state_bytes']:.4f}"
                          for m in mem.values()), flush=True)
    return done


@pytest.mark.parametrize("size", ZERO_SIZES)
def test_nccl_zero_equals_the_replicated_update(zero_jobs, size):
    for r in range(size):
        res = zero_jobs["zero", size][r]
        for key, d in res["diffs"].items():
            if size == 2:
                assert d["equal"], (r, key, d)
            else:
                assert d["close"] and d["loss_rel"] <= 1e-6, \
                    (r, key, d)
        for name in ("sgd", "adam"):
            zb = res[f"{name}.state_bytes"]
            rb = res[f"{name}.replicated_state_bytes"]
            assert rb / size * 0.9 < zb < rb / size * 1.1, (zb, rb)
        for codec in ("int8", "fp8"):
            assert res[f"{codec}.error_feedback"] and \
                res[f"{codec}.residuals"] == 1
        for what in ("step", "sync"):
            assert "cannot reshard optimizer state in place" in \
                res[f"bump.{what}"]


@pytest.mark.parametrize("size", ZERO_SIZES)
def test_nccl_zero_codec_legs_stay_near_the_exact_update(zero_jobs, size):
    import numpy as np
    for r in range(size):
        got = zero_jobs["npz", size][r]
        for codec, tol in (("int8", 2e-2), ("fp8", 5e-2), ("fp16", 1e-3)):
            for i in range(3):
                np.testing.assert_allclose(got[f"{codec}.p{i}"],
                                           got[f"none.p{i}"], atol=tol,
                                           err_msg=f"{codec} leaf {i}")


@pytest.mark.parametrize("size", ZERO_SIZES)
def test_nccl_zero_lowers_peak_memory_per_rank(zero_jobs, size):
    for r in range(size):
        res = zero_jobs["memory", size][r]
        rep, zero = res["replicated.state_bytes"], res["zero.state_bytes"]
        assert rep / size * 0.99 < zero < rep / size * 1.01, (zero, rep)
        assert res["zero.peak"] < res["replicated.peak"], res
        for a, b in zip(res["zero.losses"], res["replicated.losses"]):
            assert abs(a - b) <= 1e-6 * abs(b), res


def test_nccl_zero_plan_mismatch_fails_in_negotiation(zero_jobs):
    for r in range(2):
        err = zero_jobs["mismatch", 2][r]["error"]
        assert "zero.rs." in err and "mismatched shapes" in err, err
