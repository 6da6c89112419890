"""The port's crash-safe checkpoints (``horovod_tpu_torch/checkpoint.py``)
against the JAX package's (``horovod_tpu/checkpoint.py``,
``tests/test_guardian.py``), and ZeRO-1 state through a checkpoint at a
new world size, on the CPU.

Single process: files of float32 and integer leaves, nested dicts, lists
and scalars written by either package read back by the other, and the
same small state (numpy leaves, or the port's tensors of them) gives the
same bytes from both; ``verify_checkpoint`` gives the JAX package's verdict on a
truncated file, a flipped payload byte, a foreign MAGIC and a torn trailer;
``restore_latest`` falls back past a corrupt newest step, raises when no
step is intact, retention keeps N, stray files are skipped with the same
steps listed; bfloat16 leaves come back bit-exact through their float32
widening; the JAX package's legacy directories raise naming that format.

Launcher jobs (tests/torch_port_guardian_worker.py ``zero_save`` and
``zero_restore``, the gloo-delegated plane): ZeRO-1 SGD with momentum on
the JAX package's test model, saved after 3 steps at n = 2 and restored at
n = 3 and n = 1 (the state broadcast from rank 0 in pieces of 1,000
bytes, as a full-width state crosses in pieces of 1 GiB). The saved
per-leaf moments equal the JAX package's
``unshard_moments`` of the same 3 steps on a 2-device mesh (1e-6); the 2
steps after the restore equal, within 1e-6, the uninterrupted run at n = 2
and a replicated single-process run of the same global batch (each rank's
mean over an equal share of the rows).
"""

import os

import numpy as np
import pytest
import torch

import torch_port_launch
from horovod_tpu_torch import checkpoint as tckpt
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from test_torch_port_guardian import finish_job, ok, start_job
from torch_port_guardian_worker import CKPT_STEP, MORE_STEPS, zero_batch


def _state():
    """Keys in sorted order: the JAX package's tree_map sorts a dict's."""
    rng = np.random.RandomState(0)
    return {"a_params": {"b": rng.randn(5).astype(np.float32),
                         "w": rng.randn(13, 5).astype(np.float32)},
            "b_count": np.int64(7), "c_ids": np.arange(6, dtype=np.int32),
            "d_list": [np.float32(1.5), {"e": rng.randn(4).astype(
                np.float32)}], "epoch": 3, "name": "run"}


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _as_tensors(state):
    """The port's side of the same state: tensors where the JAX side has
    arrays."""
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state.copy())
    if isinstance(state, dict):
        return {k: _as_tensors(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_as_tensors(v) for v in state]
    return state


def test_files_of_either_package_read_back_in_the_other(tmp_path):
    from horovod_tpu import checkpoint as jckpt
    state = _state()
    jckpt.save(tmp_path / "jax", state)
    _assert_equal(tckpt.restore(tmp_path / "jax"), state)
    tckpt.save(tmp_path / "port", _as_tensors(state))
    _assert_equal(jckpt.restore(tmp_path / "port"), state)
    # The same bytes: the framing, the footer and the pickle.
    assert (tmp_path / "jax").read_bytes() == \
        (tmp_path / "port").read_bytes()
    # A leaf large enough that the pickler hands it over outside its
    # frames: the port streams it into the file (other frame boundaries
    # than the JAX package's one bytes object), and each package reads
    # the other's file.
    big = dict(state, table=np.random.RandomState(1).randn(
        300, 1000).astype(np.float32))
    jckpt.save(tmp_path / "jax_big", big)
    _assert_equal(tckpt.restore(tmp_path / "jax_big"), big)
    tckpt.save(tmp_path / "port_big", _as_tensors(big))
    _assert_equal(jckpt.restore(tmp_path / "port_big"), big)


def _damage(path, how):
    data = bytearray(path.read_bytes())
    if how == "truncated":
        data = data[:len(data) // 2]
    elif how == "flipped":
        data[len(tckpt.MAGIC) + 40] ^= 0x01
    elif how == "foreign":
        data[:len(tckpt.MAGIC)] = b"NOTACKPTXXX\n"
    elif how == "trailer":
        data[-3] ^= 0xFF
    elif how == "tiny":
        data = data[:10]
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["truncated", "flipped", "foreign",
                                 "trailer", "tiny"])
def test_verify_gives_the_jax_package_verdict(tmp_path, how):
    from horovod_tpu import checkpoint as jckpt
    path = tmp_path / "step_1"
    tckpt.save(path, _as_tensors(_state()))
    assert tckpt.verify_checkpoint(str(path)) == (True, "")
    _damage(path, how)
    got = tckpt.verify_checkpoint(str(path))
    assert got == jckpt.verify_checkpoint(str(path))
    assert got[0] is False
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        tckpt.restore(path)


def _steps(tmp_path, steps):
    for s in steps:
        tckpt.save_step(tmp_path, s, {"step": s, "w": torch.full((3,),
                                                               float(s))})


def test_restore_latest_falls_back_past_a_corrupt_step(tmp_path):
    from horovod_tpu import checkpoint as jckpt
    _steps(tmp_path, (1, 2, 3))
    _damage(tmp_path / "step_3", "flipped")
    step, state = tckpt.restore_latest(tmp_path)
    assert step == 2 and state["step"] == 2
    np.testing.assert_array_equal(state["w"], np.full(3, 2.0, np.float32))
    assert jckpt.restore_latest(tmp_path)[0] == 2
    for s in (1, 2):
        _damage(tmp_path / f"step_{s}", "truncated")
    with pytest.raises(CheckpointCorruptError, match="refusing"):
        tckpt.restore_latest(tmp_path)
    assert tckpt.restore_latest(tmp_path / "none") == (None, None)


def test_retention_and_stray_files(tmp_path, monkeypatch):
    from horovod_tpu import checkpoint as jckpt
    monkeypatch.setenv("HVDTPU_CHECKPOINT_KEEP", "2")
    (tmp_path / "step_x.swp").write_text("editor")
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "step_9.tmp.123").write_text("partial")
    _steps(tmp_path, (1, 2, 3, 4))
    assert sorted(tckpt._list_steps(str(tmp_path))) == \
        sorted(jckpt._list_steps(str(tmp_path))) == [3, 4]
    assert tckpt.latest_step(tmp_path) == jckpt.latest_step(tmp_path) == 4
    assert sorted(os.listdir(tmp_path)) == [
        "notes.txt", "step_3", "step_4", "step_9.tmp.123", "step_x.swp"]


def test_sixteen_bit_leaves_come_back_bit_exact(tmp_path):
    from horovod_tpu import checkpoint as jckpt
    x = torch.randn(64, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tckpt.save(tmp_path / "bf", {"x": x})
    got = tckpt.restore(tmp_path / "bf")["x"]
    assert got.dtype == np.float32
    assert torch.equal(tckpt.to_tensors(got).to(torch.bfloat16), x)
    np.testing.assert_array_equal(jckpt.restore(tmp_path / "bf")["x"],
                                  got)


def test_a_legacy_directory_names_the_jax_format(tmp_path):
    (tmp_path / "step_1").mkdir()
    assert tckpt.verify_checkpoint(str(tmp_path / "step_1"))[0]
    with pytest.raises(CheckpointCorruptError, match="JAX package"):
        tckpt.restore(tmp_path / "step_1")


def test_a_torn_save_leaves_the_old_file(tmp_path, monkeypatch):
    path = tmp_path / "ck"
    tckpt.save(path, {"v": 1})

    class Boom:
        def __reduce__(self):
            raise RuntimeError("crash mid-save")

    with pytest.raises(RuntimeError, match="crash mid-save"):
        tckpt.save(path, {"v": 2, "boom": Boom()})
    assert tckpt.restore(path) == {"v": 1}
    assert os.listdir(tmp_path) == ["ck"]


@pytest.fixture
def port():
    import horovod_tpu_torch as thvd
    thvd.shutdown()
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("make_opt", [
    lambda p: torch.optim.AdamW(p, lr=1e-2),
    lambda p: torch.optim.SGD(p, lr=1e-2, momentum=0.9)],
    ids=["adamw", "sgd"])
def test_zero_state_through_a_file_continues_bit_exact(port, tmp_path,
                                                       monkeypatch,
                                                       make_opt):
    # Several buckets and chunks; AdamW counts its step in place, once per
    # bucket, so a restored step must not be shared between buckets.
    from horovod_tpu_torch import train
    monkeypatch.setenv("HVDTPU_ZERO_BUCKET_BYTES", "256")
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", "1200")
    x = torch.randn(300, generator=torch.Generator().manual_seed(1))

    def make():
        g = torch.Generator().manual_seed(0)
        return [torch.nn.Parameter(torch.randn(n, generator=g))
                for n in (300, 50, 7)]

    def loss_fn(ps, b):
        return (ps[0] * b).sum() ** 2 + (ps[1] ** 3).sum() + \
            ps[2].sum() ** 2

    def run(params, opt, steps):
        step = train.make_train_step(loss_fn, opt)
        return [step(params, x).item() for _ in range(steps)]

    def fresh():
        thvd_restart()
        params = make()
        return params, train.DistributedOptimizer(make_opt(params),
                                                  zero=True)

    def thvd_restart():
        port.shutdown()
        port.init(device="cpu")

    params, opt = fresh()
    control = run(params, opt, 5)
    want = [p.detach().clone() for p in params]
    params, opt = fresh()
    assert len(opt._zero_rt.chunks or ()) == 0
    head = run(params, opt, 3)
    assert len(opt._zero_rt.plan.buckets) == 2 == len(opt._zero_rt.chunks)
    tckpt.save_step(tmp_path, 3, {"params": [p.detach() for p in params],
                                  "opt": opt.state_dict()})
    params, opt = fresh()
    step, state = tckpt.restore_latest(tmp_path)
    with torch.no_grad():
        for p, v in zip(params, state["params"]):
            p.copy_(torch.from_numpy(v))
    opt.load_state_dict(state["opt"])
    assert head + run(params, opt, 2) == control
    for p, w in zip(params, want):
        assert torch.equal(p.detach(), w)


# ==========================================================================
# ZeRO-1 through a checkpoint, across world sizes
# ==========================================================================

@pytest.fixture(scope="module")
def zero_jobs(tmp_path_factory):
    torch_port_launch.build_port_core()
    root = tmp_path_factory.mktemp("zero-ckpt")
    save = root / "save"
    proc, log = start_job(save, "zero_save", 2, {})
    jobs = {"save": finish_job(save, proc, log, 2)}
    started = {}
    for n in (3, 1):
        out = root / f"restore{n}"
        started[n] = (out, start_job(out, "zero_restore", n, {},
                                     args=[str(save / "ckpt")]))
    for n, (out, (proc, log)) in started.items():
        jobs[n] = finish_job(out, proc, log, n)
    return jobs


def _replicated(steps):
    """The same model, batch and SGD with momentum in one process."""
    from torch_port_zero_worker import jax_params, loss_fn
    params = [torch.tensor(v, requires_grad=True)
              for v in jax_params().values()]
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    x, y = zero_batch()
    batch = (torch.tensor(x), torch.tensor(y))
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(params, batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, [p.detach().numpy() for p in params]


def test_saved_moments_equal_the_jax_unshard_moments(zero_jobs, hvd):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    import horovod_tpu.jax as hvd_jax
    from horovod_tpu.ops import zero as jzero
    from torch_port_zero_worker import jax_params
    job = ok(zero_jobs["save"])

    def loss(p, batch):
        x, y = batch
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2) + \
            jnp.mean(p["a"] ** 2)

    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    zopt = hvd_jax.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                        zero=True)
    step = hvd_jax.make_train_step(loss, zopt, mesh=mesh, donate=False)
    params = {k: jnp.asarray(v) for k, v in jax_params().items()}
    state = zopt.init(params)
    x, y = zero_batch()
    for _ in range(CKPT_STEP):
        params, state, _ = step(params, state, (jnp.asarray(x),
                                                jnp.asarray(y)))
    per_leaf, _, _ = jzero.unshard_moments(state, zopt._zero_rt)
    assert job["res"][0]["signature"] == zopt._zero_rt.plan.signature()
    got = job["arrays"][0]
    for i, want in enumerate(per_leaf[0]):
        np.testing.assert_allclose(got[f"momentum_buffer.{i}"], want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", (3, 1))
def test_zero_state_restored_at_another_world_size(zero_jobs, n):
    save = ok(zero_jobs["save"])
    job = ok(zero_jobs[n])
    losses, leaves = _replicated(CKPT_STEP + MORE_STEPS)
    for r in range(n):
        res = job["res"][r]
        assert res["step"] == CKPT_STEP
        np.testing.assert_allclose(res["saved_losses"],
                                   save["res"][0]["losses"][:CKPT_STEP],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(res["losses"], losses[CKPT_STEP:],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["losses"],
                                   save["res"][0]["losses"][CKPT_STEP:],
                                   rtol=1e-6, atol=1e-6)
        for i, want in enumerate(leaves):
            np.testing.assert_allclose(job["arrays"][r][f"p{i}"], want,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(job["arrays"][r][f"p{i}"],
                                       save["arrays"][0][f"p{i}"],
                                       rtol=1e-6, atol=1e-6)
