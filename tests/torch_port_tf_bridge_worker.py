"""One rank of a launcher job that replays TensorFlow-free records of the
``tf.function`` bridge (tests/torch_port_fixtures/tf_*.npz), for
tests/test_torch_port_tf_records.py (two ranks on the CPU, gloo) and
tests/test_torch_port_tf_bridge_cuda.py (two GPUs, NCCL):

    python -m horovod_tpu_torch.runner.launch -np 2 python \\
        torch_port_tf_bridge_worker.py OUT [IMAGE] [BATCH] [STEPS]

- the rank record (``f(x) = x * rank + size`` through the TF binding's
  rank and size ops, recorded at rank 0 of a one-rank runtime) replayed
  at this rank;
- the ResNet-50 record through ``make_train_step`` (SGD with momentum,
  bf16 compute on a GPU, fp32 on the CPU) for STEPS steps on this rank's
  seeded batch of BATCH images of IMAGE x IMAGE: every rank starts from
  the same seeded weights and ends with the same parameters.

Each rank writes ``OUT/r<rank>.json``: its rank, the rank record's output,
the losses, a SHA-256 of every parameter and buffer after the steps, and
the backend. ``PORT_TEST_DEVICE=cpu`` runs it on the CPU.
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEV = os.environ.get("PORT_TEST_DEVICE", "cuda")
FIXTURES = os.path.join(HERE, "torch_port_fixtures")


def digest(module):
    h = hashlib.sha256()
    for t in (*module.parameters(), *module.buffers()):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def main():
    out_dir = sys.argv[1]
    image, batch, steps = (int(a) for a in (sys.argv[2:5] or (64, 2, 3)))
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.tensorflow.compile import CompiledFunction
    hvd.init(device="cpu" if DEV == "cpu" else None)
    rank = hvd.rank()
    res = {"rank": rank, "size": hvd.size(),
           "backend": dist.get_backend() if dist.is_initialized() else None}
    rank_fn = CompiledFunction.from_record(
        os.path.join(FIXTURES, "tf_rank.npz"))
    res["rank_record"] = rank_fn(np.arange(3, dtype=np.float32)) \
        .cpu().tolist()

    bf16 = hvd.device().type == "cuda"
    model = CompiledFunction.from_record(
        os.path.join(FIXTURES, "tf_resnet50.npz"), seed=0,
        compute_dtype=torch.bfloat16 if bf16 else None)
    step = model.make_train_step(torch.optim.SGD(
        model.parameters(), lr=0.05, momentum=0.9))
    rng = np.random.RandomState(100 + rank)
    x = rng.rand(batch, image, image, 3).astype(np.float32)
    y = rng.randint(0, 1000, size=(batch,)).astype(np.int32)
    res["losses"] = [float(step((x, y))) for _ in range(steps)]
    res["digest"] = digest(model)
    hvd.shutdown()
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
