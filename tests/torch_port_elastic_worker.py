"""One worker of the port's launcher jobs, for
tests/test_torch_port_elastic.py and tests/test_torch_port_nccl.py.

    python torch_port_elastic_worker.py MODE OUT

MODE ``static``: one allreduce of a rank-seeded vector; writes
``OUT/r<rank>.json``. MODE ``epochs`` (the port's counterpart of
tests/elastic_worker.py): ``ObjectState`` epochs of one allreduce each,
committed every epoch; appends ``<worker id> epoch=E rank=R size=N``
lines to the log ``OUT``, and may hard-exit once at a configured (worker,
epoch). MODE ``transformer``: a tiny TransformerLM under ``TorchState``
and the binding's grad-hook ``DistributedOptimizer``; one batch per
(step, rank) from a seed, a commit per step; may hard-exit once at a
configured (worker, step) before its backward; rank 0 writes its final
parameters to ``OUT.params.npz``, each worker's ``DONE`` line names
its device, and a ``RESET`` line after each reset names the parts of
``basics.LAST_TIMES``. The device comes from
``PORT_TEST_DEVICE`` (``cpu`` here; ``cuda`` puts rank r on its card).
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch.torch as hvd  # noqa: E402

WID = os.environ.get("HVDTPU_WORKER_ID", "static:?")
DEVICE = os.environ.get("PORT_TEST_DEVICE", "cpu")
EPOCHS = int(os.environ.get("ELASTIC_TEST_EPOCHS", "6"))
EPOCH_SLEEP = float(os.environ.get("ELASTIC_TEST_EPOCH_SLEEP", "0.3"))
KILL_WORKER = os.environ.get("ELASTIC_TEST_KILL_WORKER", "")
KILL_EPOCH = int(os.environ.get("ELASTIC_TEST_KILL_EPOCH", "-1"))


def init():
    hvd.init(device=None if DEVICE == "cuda" else DEVICE)


def log_line(path, msg):
    with open(path, "a") as f:
        f.write(f"{WID} {msg}\n")


def kill_once(path, msg):
    """Hard-exit the first time only (a marker file beside the log)."""
    marker = path + ".killed"
    if os.path.exists(marker):
        return
    open(marker, "w").close()
    log_line(path, msg)
    os._exit(17)


def static(out):
    init()
    x = np.random.RandomState(hvd.rank()).randn(5).astype(np.float32)
    got = hvd.allreduce(torch.from_numpy(x), op=hvd.Sum, name="static")
    from horovod_tpu_torch import basics
    with open(os.path.join(out, f"r{hvd.rank()}.json"), "w") as f:
        json.dump({"rank": hvd.rank(), "size": hvd.size(),
                   "sum": got.tolist(),
                   "backend": basics.runtime().backend.name,
                   "peers": os.environ.get("HVDTPU_PEERS", "")}, f)


def epochs(log):
    @hvd.elastic.run
    def train(state):
        while state.epoch < EPOCHS:
            out = hvd.allreduce(torch.ones(4), op=hvd.Sum,
                                name=f"step{state.epoch}")
            np.testing.assert_allclose(out.numpy(), float(hvd.size()))
            state.total = state.total + float(out[0])
            if WID == KILL_WORKER and state.epoch == KILL_EPOCH:
                kill_once(log, f"KILLED epoch={state.epoch}")
            log_line(log, f"epoch={state.epoch} rank={hvd.rank()} "
                          f"size={hvd.size()} pid={os.getpid()}")
            state.epoch += 1
            state.commit()
            time.sleep(EPOCH_SLEEP)
        return state.epoch

    init()
    state = hvd.elastic.ObjectState(epoch=0, total=0.0)
    final_epoch = train(state)
    log_line(log, f"DONE epoch={final_epoch} rank={hvd.rank()} "
                  f"size={hvd.size()} total={state.total}")


def transformer(log):
    from horovod_tpu_torch import basics, models
    init()
    dev = basics.device()
    cfg = models.TransformerConfig(vocab_size=64, hidden=64, layers=2,
                                   heads=4, max_len=16, dtype=torch.float32)
    model = models.TransformerLM(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def batch(step, rank):
        gen = torch.Generator(device=dev).manual_seed(1000 * step + rank)
        return torch.randint(0, cfg.vocab_size, (2, cfg.max_len + 1),
                             device=dev, generator=gen)

    @hvd.elastic.run
    def train(state):
        while state.step < EPOCHS:
            tokens = batch(state.step, hvd.rank())
            logits = model(tokens[:, :-1])
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, cfg.vocab_size).float(),
                tokens[:, 1:].reshape(-1))
            if WID == KILL_WORKER and state.step + 1 == KILL_EPOCH:
                kill_once(log, f"KILLED step={state.step + 1}")
            opt.zero_grad()
            loss.backward()
            opt.step()
            log_line(log, f"step={state.step + 1} rank={hvd.rank()} "
                          f"size={hvd.size()} loss={loss.item():.8f}")
            state.step += 1
            state.commit()
        return state.step

    state = hvd.elastic.TorchState(model, opt, step=0)
    state.register_reset_callbacks([lambda: log_line(log, "RESET " + " ".join(
        f"{part}={','.join(sorted(ms))}"
        for part, ms in sorted(basics.LAST_TIMES.items())))])
    final = train(state)
    if hvd.rank() == 0:
        np.savez(log + ".params.npz",
                 **{k: v.detach().cpu().numpy()
                    for k, v in model.state_dict().items()})
    log_line(log, f"DONE step={final} rank={hvd.rank()} size={hvd.size()} "
                  f"device={basics.device()}")


def mlp_state(rank):
    """A small MLP and its AdamW after one step on rank-seeded data (the
    same weights on every rank, different optimizer moments)."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 3))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)
    rng = np.random.RandomState(rank)
    x = torch.from_numpy(rng.randn(5, 6).astype(np.float32))
    model(x).square().mean().backward()
    opt.step()
    return model, opt


def perturb(model, opt):
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1000.0)
    model(torch.ones(2, 6)).sum().backward()
    opt.step()


def flat_state(model, opt, epoch):
    """A copy of every tensor of the model's and the optimizer's state, by
    name."""
    out = {f"model.{k}": v.detach().cpu().numpy().copy()
           for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt.{i}.{k}"] = np.array(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
    out["epoch"] = np.asarray(epoch)
    return out


def torchstate(out):
    init()
    model, opt = mlp_state(hvd.rank())
    state = hvd.elastic.TorchState(model, opt, epoch=3 + hvd.rank())
    committed = flat_state(model, opt, state.epoch)
    perturb(model, opt)
    state.epoch = 99
    state.restore()
    restored = flat_state(model, opt, state.epoch)
    assert all(np.array_equal(committed[k], restored[k]) for k in committed)
    state.sync()
    np.savez(os.path.join(out, f"r{hvd.rank()}.npz"),
             **flat_state(model, opt, state.epoch))
    # An optimizer that never stepped on rank 1 receives rank 0's state
    # (one call site on both ranks: unnamed collectives are named by it).
    fresh = torch.optim.AdamW(model.parameters(), lr=1.0)
    hvd.broadcast_optimizer_state(fresh if hvd.rank() else opt, root_rank=0)
    if hvd.rank():
        assert fresh.param_groups[0]["lr"] == 1e-2
        np.savez(os.path.join(out, "fresh1.npz"),
                 **{k: v for k, v in flat_state(model, fresh, 0).items()
                    if k.startswith("opt.")})


if __name__ == "__main__":
    mode, out = sys.argv[1], sys.argv[2]
    {"static": static, "epochs": epochs, "transformer": transformer,
     "torchstate": torchstate}[mode](out)
