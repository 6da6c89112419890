"""Worker-side rendezvous: discover peers through the launcher's KV store
(port of ``horovod_tpu/runner/rendezvous.py``).

The reference's gloo ranks bootstrap by connecting back to the driver's
HTTP store and exchanging addresses (reference:
horovod/common/gloo/gloo_context.cc:150-228 + http_store.cc). Here each
worker reserves the TCP port of its native-core listener, publishes
``rank -> ip:port``, then polls until every peer has published, yielding
the ``HVDTPU_PEERS`` list the native core consumes.

Control-plane HA: with ``HVDTPU_RENDEZVOUS_ADDRS`` (the ordered endpoint
list the driver exports) the store's address is the KV client's active
endpoint, a worker republishes its peer key after a failover (peer keys are
ephemeral, never journaled), and a peer wait re-verifies its own key while
it waits.
"""

import os
import socket
import time

from . import http_client
from ..utils import envparse
from ..utils.logging_util import get_logger

PEER_SCOPE = "peers"
#: Durable worker exit markers (elastic.py writes rc on success/
#: preempt/restart exits) — how a promoted standby, which never
#: spawned the cohort, observes worker completion.
EXIT_SCOPE = "elastic.exit"
#: How often a peer-waiting worker re-verifies its OWN published key
#: (a restored/failed-over store may have lost the ephemeral scope).
REPUBLISH_CHECK_S = 1.0


def _local_ip_towards(addr, port):
    """The local IP the rendezvous server sees us from: a UDP connect
    performs routing without sending packets (NIC selection, the analog of
    HOROVOD_GLOO_IFACE, reference: gloo_context.cc:163)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((addr, port))
        return s.getsockname()[0]
    finally:
        s.close()


def _reserve_port():
    """Reserve the native core's listen port with the socket kept open (no
    close-then-rebind window): the core adopts the bound socket when it
    starts (csrc/core/transport.cc ReserveListenPort)."""
    from .. import native
    return native.reserve_listen_port()


def rendezvous_config():
    """(addr, port, token) of the launcher's KV store, or None. With
    an ``HVDTPU_RENDEZVOUS_ADDRS`` failover list configured, the
    *active* endpoint is returned — callers holding the tuple across a
    takeover still reach the store because the KV client re-resolves
    per call, but fresh lookups should not dial a known-dead primary."""
    token = envparse.get_str(envparse.JOB_TOKEN)
    addr = envparse.get_str(envparse.RENDEZVOUS_ADDR, "")
    port = envparse.get_int(envparse.RENDEZVOUS_PORT, 0)
    if not addr or not port:
        addrs = envparse.get_str(envparse.RENDEZVOUS_ADDRS, "")
        if not addrs:
            return None
        try:
            endpoints = http_client.parse_endpoints(addrs)
        except ValueError:
            return None
        if not endpoints:
            return None
        addr, port = endpoints[0]
    addr, port = http_client.active_endpoint(addr, port)
    return addr, port, token


def bootstrap_peers(topology, deadline_s=None, scope=None, my_addr=None):
    """Publish our listener address, gather everyone's, return the peers
    csv ordered by rank (and export it as HVDTPU_PEERS). ``my_addr`` lets
    the caller reserve the listener ONCE across retries: re-reserving on a
    retry would overwrite the published key with a new port after peers
    may already have read the old one."""
    cfg = rendezvous_config()
    if cfg is None:
        raise RuntimeError(
            "no rendezvous configured: set HVDTPU_RENDEZVOUS_ADDR/PORT "
            "(the launcher does this) or provide HVDTPU_PEERS")
    addr, port, token = cfg
    if deadline_s is None:
        deadline_s = envparse.get_float(envparse.START_TIMEOUT, 120.0)
    if scope is None:
        # Elastic re-rendezvous uses one peer scope per membership version
        # so stale addresses from a previous epoch can never mix in.
        version = envparse.get_env(envparse.ELASTIC_VERSION)
        scope = f"{PEER_SCOPE}.{version}" if version else PEER_SCOPE

    if my_addr is None:
        my_ip = _local_ip_towards(addr, port)
        my_addr = f"{my_ip}:{_reserve_port()}"
    my_key = str(topology.rank)
    http_client.put_kv(addr, port, scope, my_key, my_addr, token=token)
    _arm_republish(scope, my_key, my_addr, token)

    def _heal_own_key():
        # Self-healing while we wait on peers: verify OUR OWN key is
        # still published and re-put it when the scope vanished (a
        # restarted store, or a failover to a standby that
        # deliberately does not replicate ephemeral peer keys) —
        # without this, every worker waits out the full deadline
        # against a store that will never hold the address it already
        # "published".
        mine = http_client.get_kv(addr, port, scope, my_key,
                                  token=token, retries=1, deadline=2.0)
        if mine is None:
            get_logger().warning(
                "rendezvous: own peer key %s/%s missing from the "
                "store (restore/failover?); republishing", scope,
                my_key)
            http_client.put_kv(addr, port, scope, my_key, my_addr,
                               token=token, retries=1, deadline=2.0)

    peers = []
    for r in range(topology.size):
        value = http_client.wait_for_kv(
            addr, port, scope, str(r), token=token,
            deadline_s=deadline_s, heal=_heal_own_key,
            heal_every=REPUBLISH_CHECK_S)
        peers.append(value.decode())
    peers_csv = ",".join(peers)
    os.environ["HVDTPU_PEERS"] = peers_csv
    return peers_csv


def _arm_republish(scope, key, value, token):
    """Register the failover re-registration hook for this worker's
    peer key: peer addresses are EPHEMERAL by the HA contract (never
    journaled), so after a takeover the worker republishes its own
    rank -> ip:port mapping against the new primary."""
    def _republish():
        cfg = rendezvous_config()
        if cfg is None:
            return
        a, p, tok = cfg
        http_client.put_kv(a, p, scope, key, value, token=tok,
                           retries=2, deadline=5.0)
    http_client.on_new_primary("rendezvous.peer", _republish)


# -- elastic assignment protocol ------------------------------------------
# The driver publishes, per membership version V:
#   elastic/version              -> str(V)
#   assign.V/<worker_id>         -> "rank,size,local_rank,local_size,
#                                    cross_rank,cross_size"
# and workers re-rendezvous their listeners under peers.V/<rank>.
# (Reference analog: the elastic rendezvous serving dynamic rank
# assignments from the driver's latest host allocation,
# horovod/runner/elastic/rendezvous.py:28-60.)

ELASTIC_SCOPE = "elastic"
VERSION_KEY = "version"
ASSIGN_SCOPE = "assign"


def current_elastic_version(addr, port, token):
    value = http_client.get_kv(addr, port, ELASTIC_SCOPE, VERSION_KEY,
                               token=token)
    return -1 if value is None else int(value)


class _Topo:
    def __init__(self, rank, size):
        self.rank = rank
        self.size = size


def elastic_bootstrap(deadline_s=None):
    """Fetch this worker's rank assignment at the newest membership
    version, export the topology env, and rendezvous peers. Retries across
    version bumps (a membership change mid-bootstrap restarts the exchange
    at the new version). Returns the version."""
    cfg = rendezvous_config()
    if cfg is None:
        raise RuntimeError(
            "elastic mode requires the launcher's rendezvous "
            "(HVDTPU_RENDEZVOUS_ADDR/PORT)")
    addr, port, token = cfg
    worker_id = envparse.get_env(envparse.WORKER_ID)
    if not worker_id:
        raise RuntimeError("elastic worker is missing HVDTPU_WORKER_ID")
    if deadline_s is None:
        deadline_s = envparse.get_float(envparse.START_TIMEOUT, 120.0)
    deadline = time.monotonic() + deadline_s
    # A re-init always follows a membership event, so the driver will have
    # bumped (or is about to bump) the version: joining the version we
    # were already part of would dial a dead cohort's listeners.
    prev = envparse.get_env(envparse.ELASTIC_VERSION)
    min_version = int(prev) + 1 if prev is not None else 0
    if min_version > current_elastic_version(addr, port, token):
        # Ask the driver to re-rendezvous: a failure with no process death
        # (a transient socket error, an injected error) changes no
        # membership, so without this request the version would never
        # move and every worker would wedge waiting for it.
        http_client.put_kv(addr, port, ELASTIC_SCOPE,
                           f"rereq.{worker_id}", str(min_version),
                           token=token)

    # One listener reservation for the whole bootstrap: retries must
    # republish the SAME address, and each reservation pins an fd.
    my_ip = _local_ip_towards(addr, port)
    my_addr = f"{my_ip}:{_reserve_port()}"

    while True:
        version = current_elastic_version(addr, port, token)
        line = None
        if version >= min_version:
            line = http_client.get_kv(addr, port,
                                      f"{ASSIGN_SCOPE}.{version}",
                                      worker_id, token=token)
        if line is None:
            # Assignment not published yet (driver still collecting hosts,
            # or we are not part of this version).
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no elastic assignment for worker {worker_id} within "
                    f"{deadline_s}s (version={version})")
            time.sleep(0.1)
            continue

        fields = [int(x) for x in line.decode().split(",")]
        rank, size, local_rank, local_size, cross_rank, cross_size = fields
        os.environ.update({
            "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(size),
            "HVDTPU_LOCAL_RANK": str(local_rank),
            "HVDTPU_LOCAL_SIZE": str(local_size),
            "HVDTPU_CROSS_RANK": str(cross_rank),
            "HVDTPU_CROSS_SIZE": str(cross_size),
            "HVDTPU_ELASTIC_VERSION": str(version),
        })
        os.environ.pop("HVDTPU_PEERS", None)
        try:
            # Short per-attempt window: if the membership changes while we
            # wait for peers, the version check below restarts us instead
            # of burning the whole start timeout on a dead cohort.
            attempt = min(15.0, max(1.0, deadline - time.monotonic()))
            bootstrap_peers(_Topo(rank, size), deadline_s=attempt,
                            scope=f"{PEER_SCOPE}.{version}",
                            my_addr=my_addr)
            return version
        except TimeoutError:
            if (current_elastic_version(addr, port, token) == version
                    and time.monotonic() > deadline):
                raise
            # else: version moved (or time remains): retry.
