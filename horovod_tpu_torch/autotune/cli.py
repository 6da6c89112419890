"""``hvd-autotune``: inspect the warm-start store (port of
``horovod_tpu/autotune/cli.py``):
``python -m horovod_tpu_torch.autotune.cli show --cache PATH``.

Subcommands:

- ``show``    — render every cache entry (key, config, score, elastic
  version, age); ``--json`` for machines.
- ``history`` — dump one entry's sweep history (the per-round
  candidate scores the winner emerged from).
- ``diff``    — compare two store files (or the same file over time):
  added/removed keys and per-key config/score deltas.
- ``clear``   — delete one entry (``--key``) or the whole file.

The cache path comes from ``--cache`` or ``HVDTPU_AUTOTUNE_CACHE``.
Exit codes: 0 success, 1 usage/subcommand failure, 2 unreadable store.
"""

import argparse
import json
import sys
import time

from . import store
from ..utils import envparse


def _resolve_cache(args):
    path = args.cache or envparse.get_str(envparse.AUTOTUNE_CACHE, "")
    if not path:
        print("hvd-autotune: no cache path (pass --cache or set "
              "HVDTPU_AUTOTUNE_CACHE)", file=sys.stderr)
        raise SystemExit(1)
    return path


def _load(path):
    try:
        return store.load(path)
    except store.StoreError as exc:
        print(f"hvd-autotune: {exc}", file=sys.stderr)
        raise SystemExit(2)


def _fmt_config(cfg):
    parts = []
    for key in store.CONFIG_KEYS:
        val = cfg.get(key)
        if val is not None:
            parts.append(f"{key}={val}")
    return " ".join(parts) or "(empty)"


def _age(entry):
    ts = entry.get("updated_unix")
    if not ts:
        return "-"
    return f"{(time.time() - float(ts)) / 3600.0:.1f}h"


def cmd_show(args):
    entries = _load(_resolve_cache(args))
    if args.json:
        print(json.dumps(entries, indent=1, sort_keys=True))
        return 0
    if not entries:
        print("(empty store)")
        return 0
    for key in sorted(entries):
        e = entries[key]
        print(f"{key}")
        print(f"  config:  {_fmt_config(e.get('config') or {})}")
        print(f"  score:   {e.get('score', 0.0):.1f} "
              f"({e.get('score_source', '?')})  "
              f"elastic_version={e.get('elastic_version', '?')}  "
              f"age={_age(e)}")
    return 0


def _pick_entry(entries, key, path):
    if key:
        if key not in entries:
            print(f"hvd-autotune: no entry {key!r} in {path}",
                  file=sys.stderr)
            raise SystemExit(1)
        return key
    if len(entries) == 1:
        return next(iter(entries))
    print(f"hvd-autotune: {len(entries)} entries in {path}; pick one "
          "with --key (see `hvd-autotune show`)", file=sys.stderr)
    raise SystemExit(1)


def cmd_history(args):
    path = _resolve_cache(args)
    entries = _load(path)
    key = _pick_entry(entries, args.key, path)
    rows = entries[key].get("history") or []
    if args.json:
        print(json.dumps({"key": key, "history": rows}, indent=1))
        return 0
    print(f"{key}: {len(rows)} scored window(s)")
    print("  arm          round  candidate             score")
    for arm, rnd, cand, mean in rows:
        print(f"  {arm:<12} {rnd:>5}  {str(cand):<20} {mean:>9.1f}")
    return 0


def cmd_diff(args):
    a, b = _load(args.old), _load(args.new)
    changed = False
    for key in sorted(set(a) | set(b)):
        if key not in a:
            print(f"+ {key}: {_fmt_config(b[key].get('config') or {})}")
            changed = True
            continue
        if key not in b:
            print(f"- {key}")
            changed = True
            continue
        ca, cb = a[key].get("config") or {}, b[key].get("config") or {}
        deltas = [f"{k}: {ca.get(k)} -> {cb.get(k)}"
                  for k in store.CONFIG_KEYS if ca.get(k) != cb.get(k)]
        sa, sb = a[key].get("score", 0.0), b[key].get("score", 0.0)
        if abs(sa - sb) > 1e-9:
            deltas.append(f"score: {sa:.1f} -> {sb:.1f}")
        if deltas:
            changed = True
            print(f"~ {key}")
            for d in deltas:
                print(f"    {d}")
    if not changed:
        print("(no differences)")
    return 0


def cmd_clear(args):
    path = _resolve_cache(args)
    try:
        n = store.clear(path, key=args.key or None)
    except (store.StoreError, OSError) as exc:
        print(f"hvd-autotune: {exc}", file=sys.stderr)
        return 2
    what = f"entry {args.key!r}" if args.key else "store"
    print(f"cleared {what} ({n} entr{'y' if n == 1 else 'ies'}) "
          f"at {path}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="hvd-autotune",
        description="Inspect the autotune warm-start store "
                    "(docs/autotune.md)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("show", help="render every cache entry")
    p.add_argument("--cache", default="")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("history", help="one entry's sweep history")
    p.add_argument("--cache", default="")
    p.add_argument("--key", default="")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser("diff", help="compare two store files")
    p.add_argument("old")
    p.add_argument("new")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("clear", help="delete an entry or the store")
    p.add_argument("--cache", default="")
    p.add_argument("--key", default="")
    p.set_defaults(fn=cmd_clear)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
