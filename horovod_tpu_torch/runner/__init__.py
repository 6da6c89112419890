"""The port's launcher (port of ``horovod_tpu/runner/``; reference:
horovod/runner/launch.py:763 ``run_commandline``).

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover.sh python train.py   (elastic)

Launch is rendezvous-based: the driver starts an HTTP KV store
(``http_server.py``), publishes slot assignments, and workers discover each
other's native-core listeners and the process group's store through it
(``rendezvous.py``). The modules are the port's own copies of the JAX
package's, which are JAX-free but import ``horovod_tpu/__init__.py``.
"""
