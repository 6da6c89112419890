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

Runtime knobs are flags that become HVDTPU_* env for the workers (the
reference's config_parser pattern,
horovod/runner/common/util/config_parser.py). The HA pair shares
``HVDTPU_JOB_TOKEN``. The JAX launcher's ``--config-file``,
``--check-build`` and ``--network-interface`` are not in this parser yet
(ROADMAP queue A, item 13).
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
    parser.add_argument("--start-timeout", type=int, default=120,
                        help="seconds workers may take to rendezvous")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--disable-prefix-output", action="store_true",
                        help="do not prefix worker output with [rank]")
    parser.add_argument("--output-filename", default=None,
                        help="directory collecting per-rank "
                             "rank.N/stdout|stderr captures")
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
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the training command to run on every slot")
    args = parser.parse_args(argv)
    if args.version:
        return args
    if not args.command:
        parser.error("no command given")
    if args.command[0] == "--":
        args.command = args.command[1:]
    return args


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


def run_commandline(argv=None):
    args = parse_args(argv)
    if args.version:
        from ..version import __version__
        print(__version__, flush=True)
        return 0
    settings = Settings(
        num_proc=args.num_proc, hosts=args.hosts, hostfile=args.hostfile,
        start_timeout=args.start_timeout, verbose=args.verbose,
        prefix_output=not args.disable_prefix_output, env=_knob_env(args),
        output_filename=args.output_filename,
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
