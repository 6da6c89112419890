"""Console client for the serving plane (port of
``horovod_tpu/serving/cli.py``, the JAX package's ``hvd-serve``).

    python -m horovod_tpu_torch.serving.cli route --kv HOST:PORT --token T \\
        --cohorts c0,c1                                       # start router
    python -m horovod_tpu_torch.serving.cli stats --url http://router:port \\
        --token T                                             # cohort view
    python -m horovod_tpu_torch.serving.cli stats --url ... --watch \\
        --interval 2                                          # live
    python -m horovod_tpu_torch.serving.cli drain c0 \\
        --url http://router:port --token T                    # drain cohort

``route`` starts a :class:`~.router.Router` HTTP surface: it discovers
cohort members from the launcher KV store (``serving/member.*`` keys
workers register), serves ``POST /v1/generate`` + ``GET
/v1/serving/stats``, and keeps membership + stats refreshed.
``stats`` polls a router's (or a single worker's) stats route.
``drain`` stops a cohort's admission — in-flight sequences complete,
new requests are rejected — through the router (which also sets the
KV drain flag workers poll). Exit codes: 0 ok, 2 usage/fetch error.
"""

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def _hostport(s):
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(
            f"expected HOST:PORT, got {s!r}")
    return host, int(port)


def _get_json(url, token, path):
    from ..runner.http_server import AUTH_HEADER
    req = urllib.request.Request(url.rstrip("/") + path)
    if token:
        req.add_header(AUTH_HEADER, token)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def _post_json(url, token, path, payload):
    from ..runner.http_server import AUTH_HEADER
    req = urllib.request.Request(
        url.rstrip("/") + path, data=json.dumps(payload).encode(),
        method="POST")
    if token:
        req.add_header(AUTH_HEADER, token)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


def _cmd_route(args):
    from .router import Router
    addr, port = args.kv
    router = Router(kv=(addr, port, args.token))
    cohorts = [c for c in args.cohorts.split(",") if c]
    try:
        found = router.refresh_from_kv(cohorts)
    except Exception as e:  # noqa: BLE001 — startup discovery is fatal
        print(f"serving cli: cannot reach KV store {addr}:{port}: {e}",
              file=sys.stderr)
        return 2
    http_port = router.serve_http(addr=args.bind, token=args.token)
    print(f"serving router on :{http_port} "
          f"(cohorts: {', '.join(f'{c}={n}' for c, n in found.items())})",
          flush=True)
    deadline = (time.monotonic() + args.serve_seconds
                if args.serve_seconds else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            time.sleep(min(args.refresh_interval,
                           1.0 if deadline else args.refresh_interval))
            try:
                router.refresh_from_kv(cohorts)
            except Exception:  # noqa: BLE001 — KV blackout: keep serving
                pass
            router.refresh_stats()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop_http()
    return 0


def _print_stats(stats):
    if stats.get("role") == "router":
        print(f"source={stats['source']} accepted={stats['accepted']} "
              f"completed={stats['completed']} "
              f"rerouted={stats['rerouted']} "
              f"rejected={stats['rejected']}")
        for cohort, c in sorted(stats.get("cohorts", {}).items()):
            print(f"  cohort {cohort}: depth={c['queue_depth']} "
                  f"running={c['running']} completed={c['completed']} "
                  f"tokens={c['tokens_out']} "
                  f"members={len(c['members'])}")
    else:
        print(json.dumps(stats, indent=1, sort_keys=True))


def _cmd_stats(args):
    try:
        while True:
            stats = _get_json(args.url, args.token, "/v1/serving/stats")
            if args.json:
                print(json.dumps(stats, indent=1, sort_keys=True))
            else:
                _print_stats(stats)
            if not args.watch:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"serving cli: stats fetch failed: {e}", file=sys.stderr)
        return 2


def _cmd_drain(args):
    try:
        status, body = _post_json(args.url, args.token,
                                  "/v1/serving/drain",
                                  {"cohort": args.cohort})
    except (urllib.error.URLError, OSError) as e:
        print(f"serving cli: drain failed: {e}", file=sys.stderr)
        return 2
    print(json.dumps(body, indent=1, sort_keys=True))
    return 0 if status == 200 else 2


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving.cli",
        description="Serving-plane console client")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("route", help="start a request router")
    p.add_argument("--kv", type=_hostport, required=True,
                   metavar="HOST:PORT",
                   help="launcher KV store the workers registered with")
    p.add_argument("--token", default="", help="job token")
    p.add_argument("--cohorts", default="c0",
                   help="comma-separated cohort names to route")
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--serve-seconds", type=float, default=0,
                   help="exit after this long (0 = run until ^C)")
    p.add_argument("--refresh-interval", type=float, default=2.0)
    p.set_defaults(fn=_cmd_route)

    p = sub.add_parser("stats", help="poll /v1/serving/stats")
    p.add_argument("--url", required=True,
                   help="router or worker base URL")
    p.add_argument("--token", default="")
    p.add_argument("--watch", action="store_true")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the summary lines")
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser("drain",
                       help="drain a cohort (finish in-flight, "
                            "reject new)")
    p.add_argument("cohort")
    p.add_argument("--url", required=True, help="router base URL")
    p.add_argument("--token", default="")
    p.set_defaults(fn=_cmd_drain)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
