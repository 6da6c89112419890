"""Launch helpers of the port's multi-process CPU tests: the rendezvous
that fills ``HVDTPU_PEERS``, the launcher environment of one rank, and the
one build of the JAX package's native library that its workers load.

Each rank reserves its native-core listen port in its own process
(``native.reserve_listen_port``: the core adopts the bound socket, so no
other process can take the port between publish and bind), publishes it as
a file in a shared directory and waits for every other rank's."""

import fcntl
import os
import socket
import subprocess
import tempfile
import time


def build_jax_native_library():
    """Build (if stale) and load the JAX package's native library in this
    process, once, before any of its workers start. Each worker of the JAX
    package runs ``make`` in ``csrc/`` when the library is missing or older
    than its sources, and several workers starting together would run it
    at the same moment and fail. An exclusive file lock serializes the
    pytest processes of an xdist run; a build (or a load) that another
    process's ``make`` broke meanwhile is retried once under the lock."""
    from horovod_tpu import native
    path = os.path.join(tempfile.gettempdir(), "hvdtpu-jax-native.lock")
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            try:
                return native.load_library()
            except (subprocess.CalledProcessError, OSError):
                time.sleep(1.0)
                return native.load_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def free_port():
    """A free port for torch.distributed's store (bound by rank 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def peers(rdv_dir, rank, size, reserve_port, timeout=120):
    """Reserve this rank's port, publish it, and return the job's
    ``host:port,...`` list in rank order."""
    port = reserve_port()
    tmp = os.path.join(rdv_dir, f".port.{rank}.tmp")
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, os.path.join(rdv_dir, f"port.{rank}"))
    deadline = time.monotonic() + timeout
    paths = [os.path.join(rdv_dir, f"port.{r}") for r in range(size)]
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: peers did not publish ports")
        time.sleep(0.01)
    ports = []
    for p in paths:
        with open(p) as f:
            ports.append(f.read().strip())
    return ",".join(f"127.0.0.1:{p}" for p in ports)


def launcher_env(rank, size, peer_list, master_port):
    """What a launcher exports for one rank of a one-host job."""
    return {"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(size),
            "HVDTPU_LOCAL_RANK": str(rank), "HVDTPU_LOCAL_SIZE": str(size),
            "HVDTPU_CROSS_RANK": "0", "HVDTPU_CROSS_SIZE": "1",
            "HVDTPU_PEERS": peer_list, "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(master_port)}


def build_port_core():
    """Build the port's native core once, before a job's workers start:
    they all load it to reserve their listen ports, and a first build
    under load must not eat into their rendezvous time (the build itself
    is serialized by a file lock in ``_build.build_core``)."""
    from horovod_tpu_torch import _build
    return _build.build_core()


def run_launcher(args, cwd, env, timeout):
    """Run ``python -m horovod_tpu_torch.runner.launch ARGS`` with a time
    limit of its own; returns (exit code or "timeout", output). At the
    limit the launcher gets SIGINT, so that it stops its workers (they
    run in sessions of their own), then SIGKILL."""
    import signal
    import sys
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *args],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            out, _ = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        return "timeout", out
