"""Process spawn + output streaming for the launcher (port of
``horovod_tpu/runner/spawn.py``).

The reference execs per-slot commands over ssh threads with a
process-group-safe shell wrapper (reference:
horovod/runner/common/util/safe_shell_exec.py:270, gloo_run.py exec).
Localhost slots run as direct child process groups; remote hosts go
through ``ssh`` with the slot env inlined. Output is streamed line by
line with a ``[rank]<stream>`` prefix exactly like horovodrun.
"""

import os
import shlex
import signal
import subprocess
import sys
import threading

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def is_local(hostname):
    import socket
    if hostname in _LOCAL_NAMES:
        return True
    try:
        return hostname in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def _stream(pipe, sinks, console_sinks=()):
    """Forward lines from pipe to each (sink, prefix) pair — the console
    gets the [rank] prefix, a per-rank capture file gets the raw line
    (reference: horovod/runner/gloo_run.py MultiFile). A capture-file sink
    that fails twice in a row (disk full, dir deleted) is dropped so the
    others keep streaming and the pipe stays drained (an abandoned pipe
    would EPIPE-kill a healthy worker). Console sinks are never dropped:
    a transient EINTR/EAGAIN on the console fd must not silence a rank
    for the rest of the job — errors there are swallowed per line."""
    sinks = list(sinks)
    console_sinks = set(id(s) for s, _ in console_sinks)
    failed_once = set()
    try:
        for raw in iter(pipe.readline, b""):
            line = raw.decode(errors="replace")
            for pair in list(sinks):
                sink, prefix = pair
                try:
                    sink.write(f"{prefix}{line}")
                    sink.flush()
                    failed_once.discard(id(sink))
                except (OSError, ValueError):
                    if id(sink) in console_sinks:
                        continue  # keep console unconditionally
                    if id(sink) in failed_once:
                        sinks.remove(pair)
                    else:
                        failed_once.add(id(sink))
    finally:
        pipe.close()


def _safe_rank_name(rank):
    """Filesystem-safe capture dir component: elastic worker ids are
    'host:slot' strings — colons break non-POSIX filesystems."""
    return str(rank).replace(":", ".").replace("/", "_")


def reset_capture_dir(output_dir):
    """Remove stale rank.* capture dirs once per LAUNCH so runs don't
    concatenate and a later launch with fewer ranks doesn't leave old
    empty rank.N dirs that read as ranks-with-no-output. Per-process
    opens append so same-job elastic respawns keep earlier attempts."""
    import shutil
    if not output_dir or not os.path.isdir(output_dir):
        return
    for name in os.listdir(output_dir):
        if not name.startswith("rank."):
            continue
        try:
            shutil.rmtree(os.path.join(output_dir, name))
        except OSError:
            pass


class SlotProcess:
    """One spawned worker with its output pumps."""

    def __init__(self, slot, command, env, prefix_output=True,
                 output_dir=None, ssh_port=None, ssh_identity_file=None):
        self.slot = slot
        # hvd-sanitize tripwire: a worker spawn forks and execs (and ssh
        # dials out): never acceptable on a collective-critical thread.
        from ..analysis import sanitizer
        sanitizer.check_blocking("subprocess.Popen", slot.hostname)
        if is_local(slot.hostname):
            full_env = dict(os.environ)
            full_env.update(env)
            self.proc = subprocess.Popen(
                command, env=full_env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True)
        else:
            # Remote exec: inline the env into the remote shell line. The
            # worker's login shell provides PATH/python.
            exports = " ".join(f"{k}={shlex.quote(v)}"
                               for k, v in env.items())
            remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
                " ".join(shlex.quote(c) for c in command)
            ssh_cmd = ["ssh", "-o", "BatchMode=yes"]
            if ssh_port:
                ssh_cmd += ["-p", str(ssh_port)]
            if ssh_identity_file:
                ssh_cmd += ["-i", ssh_identity_file]
            self.proc = subprocess.Popen(
                ssh_cmd + [slot.hostname, remote],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                start_new_session=True)
        rank = slot.rank
        out_prefix = f"[{rank}]<stdout> " if prefix_output else ""
        err_prefix = f"[{rank}]<stderr> " if prefix_output else ""
        out_sinks = [(sys.stdout, out_prefix)]
        err_sinks = [(sys.stderr, err_prefix)]
        self._files = []
        if output_dir:
            # Per-rank capture alongside the console (reference:
            # gloo_run.py:157-166 output_filename/rank.N/std{out,err});
            # the file gets raw lines, the console keeps the prefix.
            rank_dir = os.path.join(output_dir,
                                    f"rank.{_safe_rank_name(rank)}")
            os.makedirs(rank_dir, exist_ok=True)
            # Append: an elastic respawn of the same rank must not
            # truncate the previous attempt's capture.
            fo = open(os.path.join(rank_dir, "stdout"), "a")
            fe = open(os.path.join(rank_dir, "stderr"), "a")
            self._files = [fo, fe]
            out_sinks.append((fo, ""))
            err_sinks.append((fe, ""))
        self._pumps = [
            threading.Thread(target=_stream,
                             args=(self.proc.stdout, out_sinks,
                                   out_sinks[:1]),
                             daemon=True),
            threading.Thread(target=_stream,
                             args=(self.proc.stderr, err_sinks,
                                   err_sinks[:1]),
                             daemon=True),
        ]
        for t in self._pumps:
            t.start()

    def poll(self):
        return self.proc.poll()

    def wait(self, timeout=None):
        rc = self.proc.wait(timeout)
        for t in self._pumps:
            t.join(timeout=5)
        for f in self._files:
            try:
                f.close()
            except OSError:
                pass
        return rc

    def terminate(self):
        """Kill the whole process group (children included)."""
        if self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass

    def kill(self):
        if self.proc.poll() is None:
            try:
                os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
