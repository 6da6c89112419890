"""Console client of the trace plane (port of
``horovod_tpu/tracing/cli.py``, the ``hvd-trace`` command):

    python -m horovod_tpu_torch.tracing.cli collect --url http://host:port --token T --out DIR
    python -m horovod_tpu_torch.tracing.cli merge DIR [shard...] --out trace.json
    python -m horovod_tpu_torch.tracing.cli report DIR [--json] [--metrics snapshot.json]
    python -m horovod_tpu_torch.tracing.cli postmortem DIR [--out bundle.json]

``collect`` pulls the shards every rank pushed to the launcher's KV store
(``trace.<version>/shard.<rank>`` and ``postmortem.<rank>``); ``merge``
writes one Perfetto/Chrome trace with a track per rank and flow arrows
joining each collective's per-rank spans; ``report`` prints the analysis
(per-step critical path, straggler attribution, comm breakdown);
``postmortem`` merges only the flight-recorder dumps of an aborted run and
summarizes their last events.
"""

import argparse
import json
import sys
import urllib.parse

from . import analyze as analyze_mod
from . import merge as merge_mod


def _build_parser():
    parser = argparse.ArgumentParser(
        prog="hvd-trace",
        description="Cross-rank trace tooling: collect shards, merge "
                    "into one Perfetto trace, analyze stragglers and "
                    "critical paths, bundle postmortems.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("collect", help="fetch pushed shards from the "
                                       "driver KV store")
    p.add_argument("--url", required=True,
                   help="driver KV store, e.g. http://10.0.0.2:41325")
    p.add_argument("--token", default="", help="job token")
    p.add_argument("--version", default="0",
                   help="elastic membership version (default 0)")
    p.add_argument("--out", default="hvd_traces",
                   help="output directory (default hvd_traces)")
    p.add_argument("--max-ranks", type=int, default=64)

    for name, hlp in (("merge", "merge shards into one Chrome trace"),
                      ("report", "print the analyzer summary"),
                      ("postmortem", "merge + summarize flight-"
                                     "recorder dumps")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("paths", nargs="+",
                       help="shard files and/or directories")
        p.add_argument("--no-align", action="store_true",
                       help="skip clock-offset alignment")
        if name == "merge":
            p.add_argument("--out", default="hvd_trace_merged.json")
        if name == "report":
            p.add_argument("--json", action="store_true",
                           help="emit the raw report dict")
            p.add_argument("--metrics", default="",
                           help="metrics snapshot JSON to reconcile "
                                "(hvd_overlap_fraction)")
        if name == "postmortem":
            p.add_argument("--out", default="",
                           help="also write the merged postmortem "
                                "trace JSON here")
    return parser


def _load(paths, kinds):
    shards = merge_mod.load_paths(paths, kinds=kinds)
    if not shards:
        print("hvd-trace: no shards found under "
              + ", ".join(paths), file=sys.stderr)
    return shards


def main(argv=None):
    args = _build_parser().parse_args(argv)

    if args.cmd == "collect":
        parsed = urllib.parse.urlparse(args.url)
        addr, port = parsed.hostname, parsed.port
        if not addr or not port:
            print(f"hvd-trace: bad --url {args.url!r} (expected "
                  "http://host:port)", file=sys.stderr)
            return 2
        written = merge_mod.collect_shards(
            addr, port, args.token, args.version, args.out,
            max_ranks=args.max_ranks)
        for path in written:
            print(path)
        print(f"hvd-trace: collected {len(written)} shard(s) into "
              f"{args.out}", file=sys.stderr)
        return 0 if written else 1

    align = not args.no_align
    kinds = ((merge_mod.POSTMORTEM_PREFIX,)
             if args.cmd == "postmortem"
             else (merge_mod.SHARD_PREFIX, merge_mod.POSTMORTEM_PREFIX)
             if args.cmd == "merge"
             else (merge_mod.SHARD_PREFIX,))
    shards = _load(args.paths, kinds)
    if not shards:
        return 1

    if args.cmd == "merge":
        trace = merge_mod.merge_shards(shards, align=align)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"hvd-trace: wrote {len(trace['traceEvents'])} events "
              f"({len(shards)} shard(s)) to {args.out}",
              file=sys.stderr)
        print(args.out)
        return 0

    if args.cmd == "report":
        metrics = None
        if args.metrics:
            try:
                with open(args.metrics) as f:
                    metrics = json.load(f)
            except (OSError, ValueError) as exc:
                print(f"hvd-trace: cannot read --metrics: {exc}",
                      file=sys.stderr)
                return 2
        report = analyze_mod.analyze(shards, align=align,
                                     metrics=metrics)
        if args.json:
            print(json.dumps(report, indent=1, default=str))
        else:
            print(analyze_mod.render_report(report))
        return 0

    # postmortem
    report = analyze_mod.analyze(shards, align=align)
    print(f"postmortem bundle: {len(shards)} rank dump(s)")
    for s in shards:
        meta = s["meta"]
        print(f"  rank {meta.get('rank', '?')}: "
              f"{len(s['events'])} event(s), reason: "
              f"{meta.get('reason', '<none>')}")
        for rec in s["events"][-5:]:
            print(f"    {rec.get('t', 0):.6f} "
                  f"{rec.get('e')}/{rec.get('cat', '')} "
                  f"{rec.get('n', '')}")
    print()
    print(analyze_mod.render_report(report))
    if args.out:
        trace = merge_mod.merge_shards(shards, align=align)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        print(f"\nmerged postmortem trace written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
