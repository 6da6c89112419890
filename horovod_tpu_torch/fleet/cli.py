"""Operator console for the chip-budget arbiter (port of
``horovod_tpu/fleet/cli.py``, the JAX package's ``hvd-fleet``).

    python -m horovod_tpu_torch.fleet.cli status --kv HOST:PORT --token T
    python -m horovod_tpu_torch.fleet.cli status --kv ... --watch \\
        --interval 2                                  # live
    python -m horovod_tpu_torch.fleet.cli lease [ID] --kv ... --token T
    python -m horovod_tpu_torch.fleet.cli knobs       # fleet knob table

``status`` reads the durable ``fleet`` KV scope (the lease ledger):
the current train/serve slot split, how many slots are out on
train->serve leases, and the in-flight lease with its state-machine
position — everything a standby promotion would recover from, which
makes this the fastest way to see what a stuck transfer is waiting
on. Exit codes: 0 ok, 2 usage/fetch error.
"""

import argparse
import json
import sys
import time

from . import ledger as ledger_mod
from .policy import fleet_knobs


def _hostport(s):
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(
            f"expected HOST:PORT, got {s!r}")
    return host, int(port)


def _status_once(ledger):
    split = ledger.split()
    if split is None:
        print("fleet: no recorded split (arbiter never ran here)")
    else:
        print(f"split: train={split['train']} serve={split['serve']} "
              f"leased_out={split.get('leased', 0)}")
    lease = ledger.active()
    if lease is None:
        print("lease: none in flight")
        return
    age = max(0.0, time.time() - lease["created"])
    print(f"lease: {lease['id']}  {lease['direction']}  "
          f"state={lease['state']}  slots={lease['slots']}  "
          f"age={age:.1f}s")
    if lease.get("wids"):
        print(f"  victims: {', '.join(lease['wids'])}")
    chain = ledger_mod.CHAINS[lease["direction"]]
    marks = ("[x]" if chain.index(lease["state"]) >= i else "[ ]"
             for i in range(len(chain)))
    print("  " + "  ".join(f"{m} {s}" for m, s in zip(marks, chain)))


def _cmd_status(args):
    addr, port = args.kv
    ledger = ledger_mod.LeaseLedger(
        ledger_mod.HttpBackend(addr, port, token=args.token))
    try:
        if not args.watch:
            _status_once(ledger)
            return 0
        while True:
            _status_once(ledger)
            print("---", flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except Exception as e:  # noqa: BLE001 — operator tool: name the failure
        print(f"hvd-fleet: cannot read ledger at {addr}:{port}: {e}",
              file=sys.stderr)
        return 2


def _cmd_lease(args):
    addr, port = args.kv
    ledger = ledger_mod.LeaseLedger(
        ledger_mod.HttpBackend(addr, port, token=args.token))
    try:
        lease = ledger.get(args.id) if args.id else ledger.active()
    except Exception as e:  # noqa: BLE001
        print(f"hvd-fleet: cannot read ledger at {addr}:{port}: {e}",
              file=sys.stderr)
        return 2
    if lease is None:
        print("no such lease" if args.id else "no lease in flight",
              file=sys.stderr)
        return 2
    print(json.dumps(lease, indent=2, sort_keys=True))
    return 0


def _cmd_knobs(_args):
    knobs = fleet_knobs()
    width = max(len(k) for k in knobs)
    for key in sorted(knobs):
        print(f"{key:<{width}}  {knobs[key]}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.fleet.cli",
        description="Inspect the fleet arbiter's lease ledger")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("status", help="slot split + in-flight lease")
    p.add_argument("--kv", type=_hostport, required=True,
                   metavar="HOST:PORT")
    p.add_argument("--token", default="")
    p.add_argument("--watch", action="store_true")
    p.add_argument("--interval", type=float, default=2.0)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("lease", help="dump a lease record as JSON")
    p.add_argument("id", nargs="?", default=None,
                   help="lease id (default: the in-flight lease)")
    p.add_argument("--kv", type=_hostport, required=True,
                   metavar="HOST:PORT")
    p.add_argument("--token", default="")
    p.set_defaults(fn=_cmd_lease)

    p = sub.add_parser("knobs", help="resolved HVDTPU_FLEET_* knobs")
    p.set_defaults(fn=_cmd_knobs)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
