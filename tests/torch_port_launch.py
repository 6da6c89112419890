"""Launch helpers of the port's multi-process CPU tests: the rendezvous
that fills ``HVDTPU_PEERS`` and the launcher environment of one rank.

Each rank reserves its native-core listen port in its own process
(``native.reserve_listen_port``: the core adopts the bound socket, so no
other process can take the port between publish and bind), publishes it as
a file in a shared directory and waits for every other rank's."""

import os
import socket
import time


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
