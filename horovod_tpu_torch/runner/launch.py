"""The port's launcher command line (port of
``horovod_tpu/runner/launch.py``; reference: horovod/runner/launch.py:763
``run_commandline``).

    python -m horovod_tpu_torch.runner.launch -np 4 python train.py
    python -m horovod_tpu_torch.runner.launch -np 8 -H host1:4,host2:4 \\
        python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 4 \\
        --host-discovery-script ./discover.sh python train.py   (elastic)
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 2 \\
        --host-discovery-script ./discover.sh --journal-dir /var/hvd/j \\
        --standby-endpoints host2:7000 python train.py   (HA primary)
    HVDTPU_DRIVER_PORT=7000 python -m horovod_tpu_torch.runner.launch \\
        -np 2 --min-np 2 --host-discovery-script ./discover.sh \\
        --standby host1:7001 python train.py             (warm standby)

    python -m horovod_tpu_torch.runner.launch --check-build
    python -m horovod_tpu_torch.runner.launch -np 2 --config-file job.yaml \\
        --network-interface eth0 python train.py

Runtime knobs are flags that become HVDTPU_* env for the workers (the
reference's config_parser pattern,
horovod/runner/common/util/config_parser.py); ``--config-file`` gives any
flag from a YAML mapping, and explicit flags win. The HA pair shares
``HVDTPU_JOB_TOKEN``.
"""

import argparse
import sys

from .job import Settings, launch_job


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.launch",
        description="Launch a horovod_tpu_torch job.",
        usage="python -m horovod_tpu_torch.runner.launch -np N [options] "
              "<command> [args...]")
    parser.add_argument("-np", "--num-proc", type=int, default=1,
                        dest="num_proc", help="number of worker processes")
    parser.add_argument("-H", "--hosts", default=None,
                        help="comma-separated host:slots list")
    parser.add_argument("--hostfile", default=None,
                        help="file with one 'host slots=N' per line")
    parser.add_argument("--version", action="store_true", dest="version",
                        help="print the horovod_tpu_torch version and exit")
    parser.add_argument("--ssh-port", type=int, default=None,
                        help="ssh port for remote worker spawn")
    parser.add_argument("--ssh-identity-file", default=None,
                        help="ssh identity (private key) file for remote "
                             "worker spawn")
    parser.add_argument("--network-interface", default=None,
                        help="network interface the driver advertises for "
                             "rendezvous (reference: horovodrun "
                             "--network-interface; default: routed "
                             "automatically)")
    parser.add_argument("--start-timeout", type=int, default=120,
                        help="seconds workers may take to rendezvous")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--disable-prefix-output", action="store_true",
                        help="do not prefix worker output with [rank]")
    parser.add_argument("--output-filename", default=None,
                        help="directory collecting per-rank "
                             "rank.N/stdout|stderr captures")
    parser.add_argument("--config-file", default=None,
                        help="YAML file of flag values (flag names with "
                             "dashes or underscores); explicit CLI flags "
                             "win")
    # Elastic flags (reference: launch.py --min-np/--max-np/
    # --host-discovery-script routed to _run_elastic).
    parser.add_argument("--min-np", type=int, default=None,
                        help="minimum workers to keep an elastic job alive")
    parser.add_argument("--max-np", type=int, default=None,
                        help="maximum workers an elastic job may use")
    parser.add_argument("--host-discovery-script", default=None,
                        help="script printing current 'host:slots' lines; "
                             "enables elastic mode")
    parser.add_argument("--reset-limit", type=int, default=None,
                        help="max elastic resets before the job aborts")
    # Control-plane HA: journaled driver state + warm-standby failover.
    parser.add_argument("--journal-dir", default=None,
                        help="directory for the driver's control-plane "
                             "journal (sets HVDTPU_DRIVER_JOURNAL; "
                             "enables the /journal standby-sync route)")
    parser.add_argument("--standby", default=None, metavar="HOST:PORT",
                        help="run as a warm STANDBY tailing the primary "
                             "driver at HOST:PORT; promotes itself when "
                             "the primary's lease expires (requires the "
                             "shared HVDTPU_JOB_TOKEN)")
    parser.add_argument("--standby-endpoints", default=None,
                        metavar="HOST:PORT[,...]",
                        help="primary: ordered standby endpoints exported "
                             "to workers as HVDTPU_RENDEZVOUS_ADDRS for "
                             "KV failover (sets "
                             "HVDTPU_DRIVER_STANDBY_ADDRS)")
    parser.add_argument("--driver-port", type=int, default=None,
                        help="fixed KV-store listen port (default: "
                             "ephemeral; standbys need one workers can "
                             "be told in advance)")
    # Runtime knobs of the control plane -> env.
    parser.add_argument("--fusion-threshold-mb", type=float, default=None)
    parser.add_argument("--cycle-time-ms", type=float, default=None)
    parser.add_argument("--cache-capacity", type=int, default=None)
    parser.add_argument("--timeline-filename", default=None)
    parser.add_argument("--timeline-mark-cycles", action="store_true",
                        help="drop an instant event per negotiation cycle "
                             "into the timeline")
    parser.add_argument("--hierarchical-threshold-mb", type=float,
                        default=None,
                        help="min buffer MiB before multi-host collectives "
                             "take the two-level intra/cross-host path; 0 "
                             "disables")
    parser.add_argument("--autotune", action="store_true")
    parser.add_argument("--autotune-log-file", default=None)
    parser.add_argument("--log-level", default=None)
    parser.add_argument("--stall-check-disable", action="store_true")
    parser.add_argument("--stall-check-time-seconds", type=float,
                        default=None)
    parser.add_argument("--stall-shutdown-time-seconds", type=float,
                        default=None)
    parser.add_argument("--check-build", action="store_true",
                        help="print the frameworks and data planes this "
                             "install supports and exit (reference: "
                             "horovodrun --check-build)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command to run on every slot")
    args = parser.parse_args(argv)
    if args.check_build or args.version:
        return args
    if not args.command:
        parser.error("no command given")
    if args.command[0] == "--":
        args.command = args.command[1:]
    if args.config_file:
        _apply_config_file(parser, args, argv)
    return args


def _explicit_dests(parser, argv):
    """Dests the user actually passed on the command line — re-parse
    with all defaults suppressed so unset flags don't appear at all
    (a value equal to its default is otherwise indistinguishable)."""
    import copy
    p = copy.deepcopy(parser)
    for action in p._actions:
        action.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(argv if argv is not None
                               else sys.argv[1:])
    return set(vars(ns))


def _apply_config_file(parser, args, argv):
    """Fill args from a YAML mapping of flag names (reference:
    horovod/runner/launch.py:513 + common/util/config_parser.py
    set_args_from_config). Explicit CLI flags win even when they equal
    the parser default; values go through the flag's argparse type.
    PyYAML is imported here only: an install without it launches jobs
    without a config file."""
    import yaml
    with open(args.config_file) as f:
        config = yaml.safe_load(f) or {}
    if not isinstance(config, dict):
        raise SystemExit(f"config file {args.config_file} must be a "
                         "YAML mapping of flag names to values")
    explicit = _explicit_dests(parser, argv)
    actions = {a.dest: a for a in parser._actions}
    for key, value in config.items():
        dest = key.replace("-", "_").lstrip("_")
        if dest in ("command", "config_file", "help"):
            raise SystemExit(f"config file cannot set '{key}'")
        if dest not in actions:
            raise SystemExit(f"unknown config key '{key}' (use the "
                             "launcher's flag names)")
        if dest in explicit:
            # Explicit CLI flags win — including over a malformed
            # config value for the same key.
            continue
        if value is None:
            raise SystemExit(f"config key '{key}' has a null value; "
                             "omit the key or give it a value")
        action = actions[dest]
        if isinstance(action, (argparse._StoreTrueAction,
                               argparse._StoreFalseAction)):
            value = _config_bool(key, value)
        elif action.type is not None:
            try:
                value = action.type(str(value))
            except (TypeError, ValueError):
                raise SystemExit(
                    f"config key '{key}': cannot convert {value!r} "
                    f"to {action.type.__name__}")
        setattr(args, dest, value)


def _config_bool(key, value):
    """Strict boolean for flag-valued config keys: bool('false') being
    True would silently enable a feature the user asked to disable."""
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("true", "1", "yes", "on"):
        return True
    if text in ("false", "0", "no", "off"):
        return False
    raise SystemExit(f"config key '{key}': expected a boolean, got "
                     f"{value!r}")


def _knob_env(args):
    env = {}
    if args.fusion_threshold_mb is not None:
        env["HVDTPU_FUSION_THRESHOLD"] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if args.cycle_time_ms is not None:
        env["HVDTPU_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HVDTPU_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.timeline_filename:
        env["HVDTPU_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HVDTPU_TIMELINE_MARK_CYCLES"] = "1"
    if args.hierarchical_threshold_mb is not None:
        env["HVDTPU_HIERARCHICAL_THRESHOLD"] = str(
            int(args.hierarchical_threshold_mb * 1024 * 1024))
    if args.autotune:
        env["HVDTPU_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HVDTPU_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.log_level:
        env["HVDTPU_LOG_LEVEL"] = args.log_level
    if args.stall_check_disable:
        env["HVDTPU_STALL_CHECK_DISABLE"] = "1"
    if args.stall_check_time_seconds is not None:
        env["HVDTPU_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_check_time_seconds)
    if args.stall_shutdown_time_seconds is not None:
        env["HVDTPU_STALL_SHUTDOWN_TIME_SECONDS"] = str(
            args.stall_shutdown_time_seconds)
    return env


def _iface_addr(iface):
    """IPv4 address of a named interface (reference: horovodrun
    --network-interface NIC pinning). None passes through — the driver
    then routes automatically (rendezvous.py _local_ip_towards)."""
    if not iface:
        return None
    import fcntl
    import socket
    import struct
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # SIOCGIFADDR; ifreq packs the interface name in the first 16
        # bytes, the sockaddr_in's address at offset 20.
        packed = fcntl.ioctl(
            s.fileno(), 0x8915,
            struct.pack("256s", iface.encode()[:15]))
        return socket.inet_ntoa(packed[20:24])
    except OSError as e:
        raise SystemExit(
            f"--network-interface {iface!r}: cannot resolve an IPv4 "
            f"address ({e}); check `ip -4 addr` for available "
            "interfaces")
    finally:
        s.close()


def check_build():
    """Print the frameworks and data planes of this install (reference:
    horovodrun --check-build). It probes and prints; it builds nothing:
    the kernels and the native core show as built when their libraries
    for this checkout's sources are on disk."""
    import torch

    from .. import _build, basics

    def probe(mod):
        try:
            __import__(mod)
            return True
        except ImportError:
            return False

    def mark(ok):
        return "X" if ok else " "

    cuda = torch.cuda.is_available()
    lines = ["horovod_tpu_torch build/runtime support:", "",
             "Frameworks:",
             f"    [X] pytorch {torch.__version__}",
             f"    [{mark(basics.cuda_built())}] CUDA "
             f"{torch.version.cuda or '(CPU-only build)'}"
             f"{'' if cuda else ' (no device visible)'}",
             f"    [{mark(probe('triton'))}] triton", "", "Data planes:"]
    for name, ok in [("NCCL", basics.nccl_built()),
                     ("gloo", basics.gloo_built()),
                     ("MPI", basics.mpi_built()),
                     ("TCP ring collectives (native core, csrc/core/)",
                      _build.core_path().exists())]:
        lines.append(f"    [{mark(ok)}] {name}")
    lines += ["", "Built from this checkout:"]
    for name in _build.LIBRARIES:
        lines.append(f"    [{mark(_build.library_path(name).exists())}] "
                     f"{name} kernels (nvcc "
                     f"{'found' if _build.nvcc_path() else 'not found'})")
    print("\n".join(lines), flush=True)
    return 0


def run_commandline(argv=None):
    args = parse_args(argv)
    if args.version:
        from ..version import __version__
        print(__version__, flush=True)
        return 0
    if args.check_build:
        return check_build()
    settings = Settings(
        num_proc=args.num_proc, hosts=args.hosts, hostfile=args.hostfile,
        start_timeout=args.start_timeout, verbose=args.verbose,
        prefix_output=not args.disable_prefix_output, env=_knob_env(args),
        output_filename=args.output_filename,
        rendezvous_addr=_iface_addr(args.network_interface),
        ssh_port=args.ssh_port, ssh_identity_file=args.ssh_identity_file)
    if (args.host_discovery_script or args.min_np or args.max_np
            or args.standby):
        from .elastic_driver import ElasticSettings, launch_elastic_job
        elastic = ElasticSettings(
            settings,
            discovery_script=args.host_discovery_script,
            min_np=args.min_np or 1,
            # None = uncapped: -np is the *starting* size, not a growth
            # limit (matching horovodrun, where --max-np is optional).
            max_np=args.max_np,
            reset_limit=args.reset_limit,
            journal_dir=args.journal_dir,
            standby_addrs=args.standby_endpoints,
            driver_port=args.driver_port)
        if args.standby:
            from .standby import launch_standby
            return launch_standby(elastic, args.command, args.standby)
        return launch_elastic_job(elastic, args.command)
    return launch_job(settings, args.command)


if __name__ == "__main__":
    sys.exit(run_commandline())
