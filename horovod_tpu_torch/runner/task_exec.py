"""Worker entry of the programmatic ``run()`` (port of
``horovod_tpu/runner/task_exec.py``; reference: horovod/runner/task_fn
executing the pickled wrapped function): load the pickled ``(func, args,
kwargs)``, run it, write this rank's result atomically as
``result_<rank>.pkl``.

    python -m horovod_tpu_torch.runner.task_exec PAYLOAD OUT_DIR
"""

import os
import pickle
import sys

from ..utils import envparse


def main():
    payload_path, out_dir = sys.argv[1], sys.argv[2]
    rank = envparse.get_int(envparse.RANK, 0)
    with open(payload_path, "rb") as f:
        func, args, kwargs = pickle.load(f)
    result = func(*args, **kwargs)
    tmp = os.path.join(out_dir, f".result_{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(out_dir, f"result_{rank}.pkl"))


if __name__ == "__main__":
    main()
