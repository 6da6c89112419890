"""Console client of the metrics plane (port of
``horovod_tpu/telemetry/cli.py``, the ``hvd-metrics`` command):

    python -m horovod_tpu_torch.telemetry.cli dump --url http://host:port --token T
    python -m horovod_tpu_torch.telemetry.cli dump snapshot.json --format prom
    python -m horovod_tpu_torch.telemetry.cli watch --url ... --interval 2
    python -m horovod_tpu_torch.telemetry.cli diff before.json after.json

``dump`` prints a snapshot as Prometheus text (default) or JSON; a URL
source reads the launcher's token-gated ``/metrics.json`` route (the
launcher's own registry plus the ranks' pushed snapshots, rolled up), a
file source a snapshot written by ``HVDTPU_METRICS_DUMP``. ``watch``
re-reads on an interval and prints per-second rates of the series that
moved. ``diff`` subtracts two snapshot files: counter deltas and histogram
count and sum deltas. Either package's snapshots are read alike. Exit
codes: 0 ok, 2 usage or fetch error.
"""

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

from . import aggregate, exposition


def _fetch_url(url, token):
    req = urllib.request.Request(url.rstrip("/") + "/metrics.json")
    if token:
        from ..runner.http_server import AUTH_HEADER
        req.add_header(AUTH_HEADER, token)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _load(source, token):
    """A snapshot dict from a URL (http[s]://) or a JSON file path."""
    if source.startswith(("http://", "https://")):
        payload = _fetch_url(source, token)
        # The route returns {"local": ..., "ranks": {...}}; a bare
        # registry snapshot has "families" at top level.
        if "families" in payload:
            return payload
        snaps = {int(r): s for r, s in payload.get("ranks", {}).items()}
        if snaps:
            merged = dict(payload.get("local", {"families": {}}))
            merged = {"ts": merged.get("ts", time.time()),
                      "families": dict(merged.get("families", {}))}
            merged["families"].update(
                aggregate.aggregate(snaps)["families"])
            return merged
        return payload.get("local", {"families": {}})
    with open(source) as f:
        return json.load(f)


def _flatten(snap):
    """{(family, label-tuple): scalar} for diff/watch — counters and
    gauges by value, histograms by (count, sum) pseudo-series."""
    out = {}
    for name, fam in snap.get("families", {}).items():
        for sample in fam["samples"]:
            key = (name, tuple(sorted(sample.get("labels", {}).items())))
            if fam["type"] == "histogram":
                out[key + (("__count__",),)] = float(sample["count"])
                out[key + (("__sum__",),)] = float(sample["sum"])
            else:
                out[key] = float(sample["value"])
    return out


def _key_str(key):
    name, labels = key[0], key[1]
    suffix = ""
    if len(key) == 3:
        suffix = ".count" if key[2] == ("__count__",) else ".sum"
    label_s = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{suffix}" + (f"{{{label_s}}}" if label_s else "")


def _cmd_dump(args):
    snap = _load(args.source, args.token)
    if args.format == "json":
        print(exposition.render_json(snap, indent=1))
    else:
        sys.stdout.write(exposition.render_prometheus(snap))
    return 0


def _cmd_watch(args):
    prev = None
    try:
        while True:
            snap = _load(args.source, args.token)
            flat = _flatten(snap)
            now = time.strftime("%H:%M:%S")
            print(f"-- {now} ({len(flat)} series) " + "-" * 30)
            for key in sorted(flat):
                line = f"{_key_str(key):64s} {flat[key]:14.6g}"
                if prev is not None and key in prev:
                    delta = flat[key] - prev[key]
                    if delta:
                        line += f"  (+{delta:.6g}/{args.interval:g}s)"
                print(line)
            prev = flat
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _cmd_diff(args):
    before = _flatten(_load(args.before, args.token))
    after = _flatten(_load(args.after, args.token))
    changed = 0
    for key in sorted(set(before) | set(after)):
        a, b = before.get(key, 0.0), after.get(key, 0.0)
        if a != b:
            changed += 1
            print(f"{_key_str(key):64s} {a:14.6g} -> {b:14.6g} "
                  f"({b - a:+.6g})")
    print(f"hvd-metrics: {changed} series changed")
    return 0


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="hvd-metrics",
        description="Inspect horovod_tpu_torch runtime metrics.")
    sub = parser.add_subparsers(dest="command", required=True)

    def _source_args(p):
        p.add_argument("source", nargs="?", default=None,
                       help="snapshot JSON file, or use --url")
        p.add_argument("--url", default=None,
                       help="runner HTTP server base URL "
                            "(http://driver:port)")
        p.add_argument("--token", default="",
                       help="job token for the /metrics route")

    dump = sub.add_parser("dump", help="print one snapshot")
    _source_args(dump)
    dump.add_argument("--format", choices=("prom", "json"),
                      default="prom")

    watch = sub.add_parser("watch", help="re-scrape and print rates")
    _source_args(watch)
    watch.add_argument("--interval", type=float, default=2.0)

    diff = sub.add_parser("diff", help="subtract two snapshot files")
    diff.add_argument("before")
    diff.add_argument("after")
    diff.add_argument("--token", default="")
    return parser


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.command in ("dump", "watch"):
        args.source = args.url or args.source
        if not args.source:
            print("hvd-metrics: need a snapshot file or --url",
                  file=sys.stderr)
            return 2
    try:
        if args.command == "dump":
            return _cmd_dump(args)
        if args.command == "watch":
            return _cmd_watch(args)
        return _cmd_diff(args)
    except (OSError, urllib.error.URLError, json.JSONDecodeError) as exc:
        print(f"hvd-metrics: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
