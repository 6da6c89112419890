"""The Spark torch estimator's executor body (``fit_on_parquet_torch``) at
np = 2 on two H100s, as tests/spark_torch_fit_worker.py runs it for the JAX
package: tests/torch_port_spark_worker.py under the port's launcher, one
rank per card over NCCL. The model and its batches compute on each rank's
own card; both ranks report the same averaged history and the loss falls;
rank 0's checkpoint loads and predicts on the CPU. It needs pyarrow (the
shards are parquet) and skips, naming pyarrow, where it is missing.

    python -m pytest --noconftest -m cuda -s tests/test_torch_port_spark_cuda.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
WORKER = os.path.join(REPO, "tests", "torch_port_spark_worker.py")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def test_torch_estimator_worker_loop_on_two_gpus(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (a GPU machine)")
    pytest.importorskip("pyarrow", reason="the parquet shards need pyarrow")
    import torch_port_launch
    from torch_port_spark_worker import write_parquet_dataset
    from horovod_tpu_torch.spark.store import Store
    from horovod_tpu_torch.spark.torch import TorchEstimator
    torch_port_launch.build_port_core()
    store = Store.create(str(tmp_path / "store"))
    write_parquet_dataset(store.get_train_data_path())
    out = tmp_path / "out"
    out.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HVDTPU_", "HOROVOD_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, SPARK_PKG="horovod_tpu_torch",
               STORE_PREFIX=store.prefix_path)
    t0 = time.perf_counter()
    code, log = torch_port_launch.run_launcher(
        ["-np", "2", "--start-timeout", "120", sys.executable, WORKER,
         "torch", str(out)], cwd=REPO, env=env, timeout=300)
    took = time.perf_counter() - t0
    ranks = [json.loads((out / f"r{r}.json").read_text())
             for r in range(2) if (out / f"r{r}.json").exists()]
    print(f"[spark] torch estimator body, np = 2: exit {code} in "
          f"{took:.1f} s; ranks {ranks}; card {_card()}")
    assert code == 0, log[-4000:]
    assert [r["computed_on"] for r in ranks] == [["cuda:0"], ["cuda:1"]]
    assert [r["device"] for r in ranks] == ["cuda:0", "cuda:1"]
    assert {r["backend_plane"] for r in ranks} == {"nccl"}
    for key in ("history", "history_agg"):
        hist = ranks[0][key]
        assert hist["loss"][-1] < hist["loss"][0], hist
        assert ranks[1][key] == hist
    model = TorchEstimator.load(store, "torchrun", feature_cols=["features"],
                                label_cols=["label"])
    assert model.predict([np.zeros((3, 4))]).shape == (3, 1)
