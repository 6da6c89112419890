"""The port's serving plane on the card (marker ``cuda``; skips without a
CUDA device):

- the page pool and ToyLM on ``cuda``: a scheduler stepped in lockstep
  with one on the CPU over the same requests under a pool that forces
  preemption gives the same batch compositions, stats and streams (the
  oracle's); gathers and migration records (digests included) are
  bit-equal to the CPU pool's; a decode step makes one host sync;
- ``load_from_shards`` from flat bucket shards on the card: bit-equal to
  the CPU's assembly, on the card, with no host trip;
- ``TwoDZero.to_serving`` at (dp 2, tp 2) on 4 GPUs over NCCL through
  ``resharding.execute_group`` (tests/torch_port_sharding_worker.py, mode
  ``serve_card``), bit-equal to the params before and after 2 steps.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_serving_cuda.py
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
N = 4
TIMEOUT = 600


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, int(rng.integers(4, 40))).tolist(),
             int(rng.integers(4, 40))) for _ in range(n)]


def test_scheduler_on_the_card_steps_with_the_cpus(card):
    from horovod_tpu_torch.serving import model, scheduler
    kw = dict(max_batch_tokens=64, queue_limit=32, num_pages=24,
              page_size=4, watermark=2)
    gpu = scheduler.Scheduler(model.ToyLM(device=card), **kw)
    cpu = scheduler.Scheduler(model.ToyLM(device="cpu"), **kw)
    reqs = _requests(0, 16)
    rg = [gpu.submit(scheduler.Request(f"q{i}", p, n))
          for i, (p, n) in enumerate(reqs)]
    rc = [cpu.submit(scheduler.Request(f"q{i}", p, n))
          for i, (p, n) in enumerate(reqs)]
    syncs = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while not all(r.done.is_set() for r in rc):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = gpu.step()
            syncs.append(sum("synchroniz" in str(w.message)
                             for w in caught))
            assert got == cpu.step()
            a, b = gpu.stats(), cpu.stats()
            a.pop("p99_latency")
            b.pop("p99_latency")
            assert a == b
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gpu.preemptions > 0
    assert set(syncs) == {1}, syncs
    oracle = model.ToyLM(device="cpu")
    for g, c, (p, n) in zip(rg, rc, reqs):
        assert g.tokens(timeout=1) == c.tokens(timeout=1) == \
            oracle.reference_completion(p, n)


def test_pool_gathers_and_records_on_the_card_equal_the_cpus(card):
    from horovod_tpu_torch.serving import kv_cache
    rng = np.random.default_rng(3)
    vecs = rng.integers(0, 97, (37, 4)).astype(np.float32)
    pools, tables = [], []
    for dev in (card, "cpu"):
        pool = kv_cache.PagePool(32, 4, kv_dim=4, watermark=1, device=dev)
        t = kv_cache.PageTable(pool)
        t.append(vecs[:5])
        t.append(torch.as_tensor(vecs[5:]).to(pool.device))
        pools.append(pool)
        tables.append(t)
    assert tables[0].pages == tables[1].pages
    g = pools[0].gather_many(tables[:1])[0]
    assert g.is_cuda
    assert torch.equal(g.cpu(), tables[1].gather())
    rec = pools[0].export_sequence(tables[0])
    assert rec == pools[1].export_sequence(tables[1])
    back = pools[0].import_sequence(rec)
    assert torch.equal(back.gather().cpu(), torch.as_tensor(vecs))


def test_load_from_shards_assembles_on_the_card(card):
    from horovod_tpu_torch.ops.zero import plan_zero
    from horovod_tpu_torch.serving import state
    gen = torch.Generator(device=card).manual_seed(0)
    leaves = [torch.randn(s, generator=gen, device=card)
              for s in [(300, 64), (64,), (1000, 16), (7,), (128, 128)]]
    plan = plan_zero(leaves, 4, bucket_bytes=64 * 1024)
    shards = {r: [] for r in range(4)}
    for b, s in zip(plan.buckets, plan.shards):
        buf = torch.zeros(s.padded, device=card)
        buf[:s.size] = torch.cat([leaves[i].reshape(-1)
                                  for i in b.indices])
        for r in range(4):
            shards[r].append(buf[r * s.shard_len:(r + 1) * s.shard_len])
    cpu_shards = {r: [x.cpu() for x in v] for r, v in shards.items()}
    for world, layout in ((1, state.REPLICATED), (3, state.ROWS)):
        for host in range(world):
            got, rep = state.load_from_shards(shards, plan, world, host,
                                              layout)
            want, _ = state.load_from_shards(cpu_shards, plan, world, host,
                                             layout)
            for g, w, x in zip(got, want, leaves):
                assert g.is_cuda
                assert torch.equal(g.cpu(), w)
                lo, hi = (state.row_slice(x.shape[0], world, host)
                          if layout == state.ROWS else (0, x.shape[0]))
                assert torch.equal(g, x[lo:hi])


def test_to_serving_on_four_gpus_is_bit_equal(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip(f"needs {N} CUDA devices (a multi-GPU machine)")
    import torch_port_launch
    port = torch_port_launch.free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_sharding_worker.py"),
         "serve_card", str(r), str(N), str(port), str(tmp_path)], env=env,
        stdout=open(tmp_path / f"log{r}.txt", "w"),
        stderr=subprocess.STDOUT) for r in range(N)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            codes.append("timeout")
    logs = [(tmp_path / f"log{r}.txt").read_text() for r in range(N)]
    assert codes == [0] * N, "\n".join(
        f"rank {r} exited {c}:\n{log[-4000:]}"
        for r, (c, log) in enumerate(zip(codes, logs)))
    res = [json.loads((tmp_path / f"r{r}.json").read_text())["serving"]
           for r in range(N)]
    print(f"[serving card] to_serving at (dp 2, tp 2) over NCCL: "
          f"{res[0]['leaves']} leaves, {res[0]['param_bytes']} B; "
          f"replicated in {max(r['rep_ms'] for r in res):.1f} ms "
          f"(slowest rank)", flush=True)
    assert res[0]["init_equal"] and res[0]["step_equal"]
