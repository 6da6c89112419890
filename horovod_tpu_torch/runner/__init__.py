"""The port's launcher (port of ``horovod_tpu/runner/``; reference:
horovod/runner/__init__.py:92 ``horovod.run``, launch.py:763
``run_commandline``).

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover.sh python train.py   (elastic)
    horovod_tpu_torch.run(func, num_proc=2)                   (programmatic)

Launch is rendezvous-based: the driver starts an HTTP KV store
(``http_server.py``), publishes slot assignments, and workers discover each
other's native-core listeners and the process group's store through it
(``rendezvous.py``). The modules are the port's own copies of the JAX
package's, which are JAX-free but import ``horovod_tpu/__init__.py``.
"""

import os
import pickle
import sys
import tempfile

from .job import Settings, launch_job


def run(func, args=(), kwargs=None, num_proc=1, hosts=None, hostfile=None,
        env=None, start_timeout=120, verbose=False):
    """Run ``func(*args, **kwargs)`` on ``num_proc`` workers; returns the
    list of per-rank return values ordered by rank.

    The function is pickled (by reference: workers must be able to import
    it) to a spill directory that must be visible on every host (always
    true on localhost; use a shared filesystem for multi-host jobs). Each
    worker runs ``python -m horovod_tpu_torch.runner.task_exec``; it calls
    ``horovod_tpu_torch.init()`` itself, which takes the GPU of its local
    rank unless ``func`` asks for ``init(device="cpu")``.
    """
    if kwargs is None:
        kwargs = {}
    with tempfile.TemporaryDirectory(prefix="hvdtorch_run_") as tmp:
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((func, args, kwargs), f)
        settings = Settings(num_proc=num_proc, hosts=hosts,
                            hostfile=hostfile, start_timeout=start_timeout,
                            verbose=verbose, env=env)
        command = [sys.executable, "-m",
                   "horovod_tpu_torch.runner.task_exec", payload, tmp]
        rc = launch_job(settings, command)
        if rc != 0:
            raise RuntimeError(f"the job failed with exit code {rc}")
        results = []
        for rank in range(num_proc):
            path = os.path.join(tmp, f"result_{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {rank} produced no result file (crashed after "
                    "collectives completed?)")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def run_command(command, num_proc=1, hosts=None, hostfile=None, env=None,
                start_timeout=120, verbose=False):
    """Launch an argv list across workers; returns the job exit code."""
    settings = Settings(num_proc=num_proc, hosts=hosts, hostfile=hostfile,
                        start_timeout=start_timeout, verbose=verbose,
                        env=env)
    return launch_job(settings, command)
