"""Snapshot renderers: Prometheus text format v0.0.4 and JSON (port of
``horovod_tpu/telemetry/exposition.py``, the same text byte for byte).

Prometheus's text exposition is a line protocol (``# HELP`` / ``# TYPE``
headers, ``name{label="v"} value`` samples, cumulative ``_bucket{le=...}``
series for histograms); the JSON form is the registry snapshot
(``core.Registry.snapshot``). Both render the same dict, so the
``/metrics`` route, the CLI and the cluster roll-up share one code path.
"""

import json

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v):
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _label_str(labels, extra=None):
    pairs = list(labels.items()) + list((extra or {}).items())
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def render_prometheus(snapshot):
    """Prometheus text format v0.0.4 of a registry snapshot."""
    lines = []
    for name in sorted(snapshot.get("families", {})):
        fam = snapshot["families"][name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for sample in fam["samples"]:
            labels = sample.get("labels", {})
            if fam["type"] == "histogram":
                for bound, cum in sample["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(labels, {'le': _format_value(bound)})}"
                        f" {cum}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_format_value(sample['sum'])}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{sample['count']}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_format_value(sample['value'])}")
    return "\n".join(lines) + "\n"


def render_json(snapshot, indent=None):
    return json.dumps(snapshot, indent=indent, sort_keys=True)


def parse_prometheus(text):
    """Minimal parser for the text this module renders: returns
    ``{metric_name: {label_tuple: value}}`` (no bucket reconstruction)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = tuple(
                p for p in rest.rstrip("}").split('",')
                if p) if rest else ()
        else:
            name, labels = name_part, ()
        try:
            v = float(value)
        except ValueError:
            continue
        out.setdefault(name, {})[labels] = v
    return out
