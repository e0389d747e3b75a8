"""Export surfaces: Prometheus text exposition + JSONL dumps (a copy of
``lasp_tpu.telemetry.export``).

Two consumers, two formats, one registry snapshot:

- :func:`render_prometheus` — the text exposition format (version 0.0.4)
  a Prometheus server scrapes. The bridge serves it on the ``metrics``
  protocol verb (so a BEAM node — or anything that can speak the frame
  protocol — can scrape), and ``lasp_tpu metrics`` prints it.
- :func:`dump_jsonl` — one JSON object per line: every span event in the
  ring, then one ``{"kind": "metric", ...}`` line per series. This is
  the offline-analysis surface (``lasp_tpu metrics --jsonl``).

Rendering is deterministic (names and label sets sorted), which is what
makes the golden-file test (tests/telemetry/test_prometheus.py) and
diff-based dashboards possible.
"""

from __future__ import annotations

import json

from . import registry as _registry
from . import spans as _spans


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: dict, extra: "tuple | None" = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + body + "}"


def render_prometheus(snapshot: "dict | None" = None) -> str:
    """Prometheus text exposition of ``snapshot`` (default: a fresh
    snapshot of the process-global registry)."""
    snap = _registry.get_registry().snapshot() if snapshot is None else snapshot
    lines: list[str] = []
    for name in sorted(snap):
        fam = snap[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for entry in sorted(
            fam["series"], key=lambda e: sorted(e["labels"].items())
        ):
            labels = entry["labels"]
            if fam["type"] == "histogram":
                acc = 0
                bounds = list(entry["buckets"]) + [float("inf")]
                for b, c in zip(bounds, entry["counts"]):
                    acc += c
                    le = "+Inf" if b == float("inf") else _fmt_value(b)
                    lines.append(
                        f"{name}_bucket{_label_str(labels, ('le', le))} {acc}"
                    )
                lines.append(
                    f"{name}_sum{_label_str(labels)} "
                    f"{_fmt_value(entry['sum'])}"
                )
                lines.append(
                    f"{name}_count{_label_str(labels)} {entry['count']}"
                )
            else:
                lines.append(
                    f"{name}{_label_str(labels)} {_fmt_value(entry['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def metric_events(snapshot: "dict | None" = None) -> list:
    """The snapshot as flat JSONL-able event dicts (one per series)."""
    snap = _registry.get_registry().snapshot() if snapshot is None else snapshot
    out = []
    for name in sorted(snap):
        fam = snap[name]
        for entry in sorted(
            fam["series"], key=lambda e: sorted(e["labels"].items())
        ):
            rec = {
                "kind": "metric",
                "name": name,
                "type": fam["type"],
                "labels": entry["labels"],
            }
            if fam["type"] == "histogram":
                rec["sum"] = entry["sum"]
                rec["count"] = entry["count"]
                rec["buckets"] = entry["buckets"]
                rec["counts"] = entry["counts"]
            else:
                rec["value"] = entry["value"]
            out.append(rec)
    return out


def dump_jsonl(fp, snapshot: "dict | None" = None) -> int:
    """Write the span ring then every metric series to ``fp`` as JSONL;
    returns the number of lines written."""
    n = 0
    for rec in _spans.events():
        fp.write(json.dumps(rec) + "\n")
        n += 1
    for rec in metric_events(snapshot):
        fp.write(json.dumps(rec) + "\n")
        n += 1
    return n
