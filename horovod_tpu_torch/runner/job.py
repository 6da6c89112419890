"""Static job launch: rendezvous server + slot spawn + monitoring (port of
``horovod_tpu/runner/job.py``).

The analog of the reference's gloo launch path (reference:
horovod/runner/gloo_run.py:240 ``launch_gloo``): start the in-driver
rendezvous server, compute slot assignments, build per-slot env, spawn
every slot, and tear the job down as a unit — first failure kills the
rest, matching horovodrun's all-or-nothing semantics.
"""

import time

from . import spawn
from .hosts import HostInfo, get_host_assignments, parse_hostfile, \
    parse_hosts
from .http_server import RendezvousServer, new_job_token


class Settings:
    """Launcher configuration (a subset of the reference's ~60 flags;
    reference: horovod/runner/launch.py:242)."""

    def __init__(self, num_proc=1, hosts=None, hostfile=None,
                 start_timeout=120, verbose=False, prefix_output=True,
                 env=None, rendezvous_addr=None, output_filename=None,
                 ssh_port=None, ssh_identity_file=None):
        self.num_proc = num_proc
        self.hosts = hosts
        self.hostfile = hostfile
        self.start_timeout = start_timeout
        self.verbose = verbose
        self.prefix_output = prefix_output
        self.env = dict(env or {})   # extra env forwarded to every slot
        self.rendezvous_addr = rendezvous_addr
        # Directory for per-rank rank.N/stdout|stderr capture (reference:
        # horovodrun --output-filename).
        self.output_filename = output_filename
        # Remote-spawn ssh options (reference: horovodrun --ssh-port /
        # --ssh-identity-file).
        self.ssh_port = ssh_port
        self.ssh_identity_file = ssh_identity_file

    def resolve_hosts(self):
        if self.hosts:
            return parse_hosts(self.hosts)
        if self.hostfile:
            return parse_hostfile(self.hostfile)
        return [HostInfo("localhost", self.num_proc)]


def _rendezvous_ip(slots):
    """Address workers use to reach the driver's KV store."""
    if all(spawn.is_local(s.hostname) for s in slots):
        return "127.0.0.1"
    import socket
    return socket.gethostbyname(socket.getfqdn())


def launch_job(settings, command):
    """Run ``command`` (argv list) across all slots; returns the job's
    exit code (0 only when every rank exits 0)."""
    slots = get_host_assignments(settings.resolve_hosts(), settings.num_proc)
    spawn.reset_capture_dir(settings.output_filename)
    token = new_job_token()
    server = RendezvousServer(job_token=token, verbose=settings.verbose)
    port = server.start()
    server.publish_assignments(slots)
    addr = settings.rendezvous_addr or _rendezvous_ip(slots)

    procs = []
    try:
        for slot in slots:
            env = dict(settings.env)
            env.update(slot.to_env())
            env.update({
                "HVDTPU_RENDEZVOUS_ADDR": addr,
                "HVDTPU_RENDEZVOUS_PORT": str(port),
                "HVDTPU_JOB_TOKEN": token,
                "HVDTPU_START_TIMEOUT": str(settings.start_timeout),
            })
            procs.append(spawn.SlotProcess(
                slot, command, env, prefix_output=settings.prefix_output,
                output_dir=settings.output_filename,
                ssh_port=settings.ssh_port,
                ssh_identity_file=settings.ssh_identity_file))

        return _monitor(procs, settings)
    finally:
        for p in procs:
            p.terminate()
        deadline = time.monotonic() + 5
        for p in procs:
            if p.poll() is None and time.monotonic() < deadline:
                try:
                    p.proc.wait(max(0.1, deadline - time.monotonic()))
                except Exception:  # noqa: BLE001
                    pass
        for p in procs:
            p.kill()
        server.stop()


def _monitor(procs, settings):
    """Wait for all slots; on first nonzero exit, give the rest a grace
    period then kill (the native core's consensus shutdown usually lets
    peers exit cleanly first)."""
    pending = list(procs)
    first_bad = 0
    fail_deadline = None
    while pending:
        for p in list(pending):
            rc = p.poll()
            if rc is None:
                continue
            p.wait()
            pending.remove(p)
            if rc != 0 and first_bad == 0:
                first_bad = rc
                fail_deadline = time.monotonic() + 10
                if settings.verbose:
                    print(f"launch: rank {p.slot.rank} exited with "
                          f"code {rc}; terminating remaining ranks")
        if fail_deadline is not None and time.monotonic() > fail_deadline:
            for p in pending:
                p.terminate()
            fail_deadline = time.monotonic() + 1e9  # terminate once
        time.sleep(0.05)
    return first_bad
