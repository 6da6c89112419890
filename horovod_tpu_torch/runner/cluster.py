"""Shared machinery for cluster-framework launches (port of
``horovod_tpu/runner/cluster.py``; Spark / Ray).

The reference's Spark and Ray integrations both reduce to: the driver runs
a rendezvous, the framework places N opaque tasks, and each task derives
its rank/local/cross topology and connects back (reference:
horovod/spark/runner.py:197 task fn + gloo rendezvous;
horovod/ray/runner.py:45-130 Coordinator collecting hostnames -> ranks).
This module is that common core, framework-free and testable without
pyspark or ray: :class:`ClusterJob` is the driver side, and
:func:`cluster_task_bootstrap` is what every placed task calls before
``horovod_tpu_torch.init()``.
"""

import os
import socket

from . import http_client
from .http_server import RendezvousServer, new_job_token
from .rendezvous import _local_ip_towards

HOST_SCOPE = "cluster_hosts"


class ClusterJob:
    """Driver-side state for one cluster-framework job. ``addr`` is the
    address tasks reach the driver's store at (default: the routable
    address :func:`local_driver_ip` finds)."""

    def __init__(self, num_proc, start_timeout=120, addr=None):
        self.num_proc = num_proc
        self.start_timeout = start_timeout
        self.token = new_job_token()
        self.server = RendezvousServer(job_token=self.token)
        self.port = self.server.start()
        # Routable driver address: hostname resolution commonly yields
        # 127.0.0.1 on cluster nodes, which would make remote workers
        # rendezvous with themselves.
        self.addr = addr or local_driver_ip()

    def task_args(self):
        """The picklable tuple a task needs to bootstrap."""
        return (self.num_proc, self.addr, self.port, self.token,
                self.start_timeout)

    def shutdown(self):
        self.server.stop()


def cluster_task_bootstrap(rank, num_proc, addr, port, token,
                           start_timeout=120):
    """Run inside a placed task BEFORE ``init()``: exchange hostnames
    through the driver's KV store, derive local/cross ranks (the analog of
    the reference Ray Coordinator's hostname->rank grouping,
    horovod/ray/runner.py:45-130), and export the topology env. Peer
    discovery then rides the normal rendezvous path inside init()."""
    my_host = socket.gethostname()
    http_client.put_kv(addr, port, HOST_SCOPE, str(rank), my_host,
                       token=token)
    hosts = []
    for r in range(num_proc):
        hosts.append(http_client.wait_for_kv(
            addr, port, HOST_SCOPE, str(r), token=token,
            deadline_s=start_timeout).decode())

    # Deterministic local/cross assignment from the (host, rank) pairs —
    # same semantics as the static launcher's slot math (runner/hosts.py).
    local_rank = sum(1 for r in range(rank) if hosts[r] == my_host)
    local_size = sum(1 for h in hosts if h == my_host)
    host_order = list(dict.fromkeys(hosts))
    hosts_at_lr = [h for h in host_order
                   if sum(1 for x in hosts if x == h) > local_rank]
    cross_rank = hosts_at_lr.index(my_host)
    cross_size = len(hosts_at_lr)

    os.environ.update({
        "HVDTPU_RANK": str(rank),
        "HVDTPU_SIZE": str(num_proc),
        "HVDTPU_LOCAL_RANK": str(local_rank),
        "HVDTPU_LOCAL_SIZE": str(local_size),
        "HVDTPU_CROSS_RANK": str(cross_rank),
        "HVDTPU_CROSS_SIZE": str(cross_size),
        "HVDTPU_RENDEZVOUS_ADDR": addr,
        "HVDTPU_RENDEZVOUS_PORT": str(port),
        "HVDTPU_JOB_TOKEN": token,
        "HVDTPU_START_TIMEOUT": str(start_timeout),
    })
    os.environ.pop("HVDTPU_PEERS", None)


def local_driver_ip():
    """Best-effort routable driver address (loopback jobs use 127.0.0.1;
    no packets are sent — UDP connect only performs routing)."""
    try:
        return _local_ip_towards("8.8.8.8", 53)
    except OSError:
        return "127.0.0.1"
