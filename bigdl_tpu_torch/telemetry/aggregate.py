"""Cross-host telemetry aggregation over the elastic KV transport.

Every host periodically publishes its telemetry payload (metrics
snapshot + goodput ledger + span-category totals) under
``tm/<incarnation>/<host>`` — incarnation-keyed exactly like the SDC
votes, so a post-reconfiguration cluster view never mixes in snapshots
from a membership that no longer exists.  The leader collects the
newest payload per member and merges them into one cluster view:

* counters sum; gauges report per-host values plus min/mean/max;
* histograms with identical bucket geometry merge by adding bucket
  counts (the :class:`~.registry.Histogram` merge contract);
* goodput ledgers sum per-category host-seconds
  (:meth:`~.goodput.GoodputLedger.merge_snapshots`);
* per-host step-time skew is derived from each host's published
  ``bigdl_train_step_seconds`` mean vs the cluster median.

The same payloads also serialize to a **snapshot directory** (one
``<host>.json`` per host) — what :func:`.report.render_report` renders.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Sequence

from .goodput import GoodputLedger

__all__ = [
    "TM_PREFIX", "collect_snapshots", "merge_alerts", "merge_cluster",
    "merge_incidents", "merge_metrics", "merge_perf",
    "merge_timeline", "metrics_to_prometheus", "publish_snapshot",
    "read_snapshot_dir", "write_snapshot",
]

TM_PREFIX = "tm/"


# ---------------------------------------------------------------------------
# transport plumbing
# ---------------------------------------------------------------------------

def publish_snapshot(transport, host: str, payload: dict,
                     incarnation: int = 0):
    """Publish one host's telemetry payload for the current
    incarnation (overwrites the host's previous snapshot — the view is
    "newest per host", not a journal)."""
    transport.put(f"{TM_PREFIX}{int(incarnation)}/{host}",
                  json.dumps(payload))


def collect_snapshots(transport, incarnation: int = 0,
                      members: Optional[Sequence[str]] = None
                      ) -> Dict[str, dict]:
    """The leader's read side: newest payload per host for the given
    incarnation (restricted to ``members`` when given — a departed
    host's stale snapshot must not haunt the cluster view)."""
    prefix = f"{TM_PREFIX}{int(incarnation)}/"
    out: Dict[str, dict] = {}
    for key in transport.keys(prefix):
        host = key[len(prefix):]
        if members is not None and host not in members:
            continue
        raw = transport.get(key)
        if raw is None:
            continue
        try:
            out[host] = json.loads(raw)
        except ValueError:
            continue
    return out


# ---------------------------------------------------------------------------
# snapshot directories (the run-report input)
# ---------------------------------------------------------------------------

def write_snapshot(directory: str, host: str, payload: dict) -> str:
    """Write one host's payload as ``<dir>/<host>.json`` (atomic:
    tmp + rename, same discipline as FileKV)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{host}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path


def read_snapshot_dir(directory: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json") or ".tmp." in name:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out[name[:-len(".json")]] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


# ---------------------------------------------------------------------------
# merging
# ---------------------------------------------------------------------------

def merge_metrics(metric_snaps: Sequence[dict]) -> dict:
    """Fold per-host ``MetricsRegistry.snapshot()['metrics']`` dicts
    into one cluster view.  Series are keyed by (name, labels);
    counters sum, histograms bucket-add (mismatched geometry falls back
    to count/sum only), gauges keep min/mean/max across hosts."""
    out: dict = {}
    for snap in metric_snaps:
        for name, fam in (snap or {}).items():
            dst = out.setdefault(name, {"type": fam.get("type"),
                                        "help": fam.get("help"),
                                        "series": {}})
            for series in fam.get("series", ()):
                key = json.dumps(series.get("labels") or {},
                                 sort_keys=True)
                cur = dst["series"].get(key)
                if cur is None:
                    dst["series"][key] = _copy_series(series,
                                                      fam.get("type"))
                else:
                    _fold_series(cur, series, fam.get("type"))
    # dict-of-series back to the list shape snapshots use
    for fam in out.values():
        fam["series"] = [
            dict(s, labels=json.loads(k))
            for k, s in sorted(fam["series"].items())]
    return out


def _copy_series(series: dict, kind: str) -> dict:
    s = {k: v for k, v in series.items() if k != "labels"}
    if kind == "gauge":
        s["per_host_values"] = [series.get("value", 0.0)]
    return s


def _fold_series(cur: dict, series: dict, kind: str):
    if kind == "counter":
        cur["value"] = cur.get("value", 0.0) + series.get("value", 0.0)
    elif kind == "gauge":
        vals = cur.setdefault("per_host_values", [cur.get("value", 0.0)])
        vals.append(series.get("value", 0.0))
        cur["value"] = max(vals)
        cur["min"] = min(vals)
        cur["mean"] = sum(vals) / len(vals)
    elif kind == "histogram":
        cur["count"] = cur.get("count", 0) + series.get("count", 0)
        cur["sum"] = cur.get("sum", 0.0) + series.get("sum", 0.0)
        mins = [m for m in (cur.get("min"), series.get("min"))
                if m is not None]
        maxs = [m for m in (cur.get("max"), series.get("max"))
                if m is not None]
        cur["min"] = min(mins) if mins else None
        cur["max"] = max(maxs) if maxs else None
        if cur.get("bounds") == series.get("bounds") and \
                cur.get("buckets") and series.get("buckets"):
            cur["buckets"] = [a + b for a, b in zip(cur["buckets"],
                                                    series["buckets"])]
            # exemplars DO merge: a trace id is a fleet-wide pointer
            # (the trc/ fragments live on the shared transport, not in
            # a per-host store), so the merged bucket keeps the NEWEST
            # exemplar per bucket across hosts — before this fix the
            # fold silently discarded every exemplar the PR 13 tracing
            # attached, orphaning the OpenMetrics trace links in every
            # fleet-level scrape
            merged_ex = dict(cur.get("exemplars") or {})
            for idx, ex in (series.get("exemplars") or {}).items():
                have = merged_ex.get(idx)
                if have is None or float(ex.get("ts") or 0.0) \
                        >= float(have.get("ts") or 0.0):
                    merged_ex[idx] = dict(ex)
            if merged_ex:
                cur["exemplars"] = merged_ex
            else:
                cur.pop("exemplars", None)
        else:  # geometry drift: keep count/sum, drop buckets AND
            cur.pop("buckets", None)   # their per-bucket exemplars
            cur.pop("exemplars", None)
        # per-series quantiles do not merge; the cluster view keeps
        # count/sum/min/max (+ merged buckets when geometries match)
        cur.pop("p50", None)
        cur.pop("p99", None)


def metrics_to_prometheus(metrics: dict) -> str:
    """Prometheus/OpenMetrics text of a snapshot-shaped metrics dict —
    including a MERGED cluster view (:func:`merge_metrics` output), so
    the fleet-level scrape carries the folded histograms WITH their
    surviving exemplars (the round-trip the exemplar-merge fix is
    tested through).  Mirrors ``MetricsRegistry.to_prometheus``."""
    from .registry import _esc_help, _fmt_float, _label_str

    lines = []
    for name, fam in sorted((metrics or {}).items()):
        kind = fam.get("type")
        if fam.get("help"):
            lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        for series in fam.get("series", ()):
            labels = series.get("labels") or {}
            if kind == "histogram":
                bounds = series.get("bounds")
                buckets = series.get("buckets")
                if bounds and buckets:
                    exemplars = series.get("exemplars") or {}
                    cum = 0
                    for i, (bound, c) in enumerate(zip(
                            list(bounds) + [float("inf")], buckets)):
                        cum += c
                        le = dict(labels, le=_fmt_float(bound))
                        line = f"{name}_bucket{_label_str(le)} {cum}"
                        ex = exemplars.get(str(i), exemplars.get(i))
                        if ex is not None:
                            line += (' # {trace_id="%s"} %s'
                                     % (ex["trace_id"],
                                        _fmt_float(ex["value"])))
                        lines.append(line)
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt_float(series.get('sum', 0.0))}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{series.get('count', 0)}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt_float(series.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


def merge_alerts(payloads: Dict[str, dict]) -> Optional[dict]:
    """Union per-host SLO-engine snapshots (``payload["alerts"]``,
    see ``Telemetry.payload``) into one cluster alert view: every
    host's active alerts (host-stamped), recent transitions in time
    order, and per-state totals.  None when no host published an
    engine snapshot."""
    # dedupe active by (rule, host): a rule reported twice for one
    # host (overlapping snapshot collections, a re-published payload)
    # must union to ONE deterministic entry — the worst one wins
    # (severity page > ticket, then the newest fired-at time)
    def _active_rank(a: dict):
        return (1 if a.get("severity") == "page" else 0,
                a.get("since") or 0.0)

    active_by_key: Dict[tuple, dict] = {}
    recent_by_key: Dict[tuple, dict] = {}
    totals: Dict[str, int] = {}
    hosts = []
    for host, p in sorted(payloads.items()):
        snap = (p or {}).get("alerts")
        if not snap:
            continue
        hosts.append(host)
        for a in snap.get("active", ()):
            key = (a.get("rule"), host)
            cur = active_by_key.get(key)
            if cur is None or _active_rank(a) > _active_rank(cur):
                active_by_key[key] = dict(a, host=host)
        for a in snap.get("recent", ()):
            # identical transitions replayed across overlapping
            # collections dedupe exactly; conflicting states at the
            # same instant keep the worst (firing beats resolved)
            key = (a.get("rule"), host, a.get("at"))
            cur = recent_by_key.get(key)
            if cur is not None and not (
                    a.get("state") == "firing"
                    and cur.get("state") != "firing"):
                continue
            recent_by_key[key] = dict(a, host=host)
    if not hosts:
        return None
    active = [active_by_key[k] for k in sorted(
        active_by_key, key=lambda k: (str(k[0]), str(k[1])))]
    recent = sorted(recent_by_key.values(),
                    key=lambda a: (a.get("at") or 0.0,
                                   str(a.get("rule")),
                                   str(a.get("host"))))
    for a in recent:
        state = a.get("state", "?")
        totals[state] = totals.get(state, 0) + 1
    worst = "ok"
    if any(a.get("severity") == "page" for a in active):
        worst = "critical"
    elif active:
        worst = "degraded"
    return {"hosts": hosts, "active": active, "recent": recent[-64:],
            "totals": totals, "verdict": worst}


def merge_incidents(payloads: Dict[str, dict]) -> Optional[dict]:
    """Union per-host incident-engine snapshots
    (``payload["incidents"]``, see ``Telemetry.payload``) into one
    cluster incident view: every host's open and recent (finalized)
    incidents, host-stamped, deduped by (id, host), ordered by opened
    time.  None when no host published an engine snapshot."""
    open_by_key: Dict[tuple, dict] = {}
    recent_by_key: Dict[tuple, dict] = {}
    hosts = []
    opened = 0
    for host, p in sorted(payloads.items()):
        snap = (p or {}).get("incidents")
        if not snap:
            continue
        hosts.append(host)
        opened += int(snap.get("opened") or 0)
        for inc in snap.get("open", ()):
            open_by_key[(inc.get("id"), host)] = dict(inc, host=host)
        for inc in snap.get("recent", ()):
            # a finalized re-publish of a previously-open incident
            # replaces the open entry for the same (id, host)
            key = (inc.get("id"), host)
            open_by_key.pop(key, None)
            recent_by_key[key] = dict(inc, host=host)
    if not hosts:
        return None
    def order(i: dict):
        return (i.get("opened_at") or 0.0, str(i.get("id")),
                str(i.get("host")))

    return {"hosts": hosts,
            "open": sorted(open_by_key.values(), key=order),
            "recent": sorted(recent_by_key.values(), key=order),
            "opened": opened}


def host_skew(payloads: Dict[str, dict]) -> Dict[str, dict]:
    """Per-host mean step time and skew vs the cluster median, from
    each host's published ``bigdl_train_step_seconds`` histogram."""
    means: Dict[str, float] = {}
    for host, payload in payloads.items():
        fam = ((payload.get("metrics") or {})
               .get("bigdl_train_step_seconds"))
        if not fam:
            continue
        for series in fam.get("series", ()):
            count = series.get("count") or 0
            if count > 0:
                means[host] = float(series.get("sum", 0.0)) / count
                break
    if not means:
        return {}
    med = statistics.median(means.values())
    return {h: {"mean_step_s": m,
                "skew": (m / med) if med > 0 else 1.0}
            for h, m in sorted(means.items())}


def merge_perf(payloads: Dict[str, dict]) -> Optional[dict]:
    """Fold per-host ``perf`` payload sections (the PerfAccountant's
    cost-model view) into the cluster perf summary: per-host FLOP
    totals sum, cluster MFU is total flops over Σ(host wall × host
    peak), program cost entries union (identical programs on every
    data-parallel host — first publisher wins, tagged with how many
    hosts reported it), HBM watermarks keep the per-host maxima."""
    per_host = {}
    programs: dict = {}
    program_hosts: Dict[str, int] = {}
    total_flops = 0.0
    denom = 0.0  # sum over hosts of wall_s x peak_flops
    hbm_peak = None
    nominal = False
    device = None
    for host, p in sorted(payloads.items()):
        perf = p.get("perf")
        if not perf:
            continue
        dev = perf.get("device") or {}
        device = device or dev
        nominal = nominal or bool(dev.get("nominal"))
        flops = float(perf.get("flops_total") or 0.0)
        wall = float((p.get("goodput") or {}).get("wall_s") or 0.0)
        peak = dev.get("peak_flops_per_sec") or 0.0
        entry = {"flops_total": flops, "wall_s": wall}
        if wall > 0 and peak:
            entry["mfu"] = flops / wall / peak
            denom += wall * peak
        total_flops += flops
        hbm = perf.get("hbm") or {}
        if hbm.get("peak_bytes_in_use") is not None:
            entry["hbm_peak_bytes"] = hbm["peak_bytes_in_use"]
            hbm_peak = max(hbm_peak or 0.0, hbm["peak_bytes_in_use"])
            if hbm.get("bytes_limit") is not None:
                entry["hbm_limit_bytes"] = hbm["bytes_limit"]
        per_host[host] = entry
        for label, prog in (perf.get("programs") or {}).items():
            programs.setdefault(label, dict(prog))
            program_hosts[label] = program_hosts.get(label, 0) + 1
    if not per_host:
        return None
    for label, n in program_hosts.items():
        programs[label]["reporting_hosts"] = n
    out = {
        "flops_total": total_flops,
        "cluster_mfu": (total_flops / denom) if denom > 0 else None,
        "nominal_device": nominal,
        "device": device,
        "per_host": per_host,
        "programs": programs,
    }
    if hbm_peak is not None:
        out["hbm_peak_bytes"] = hbm_peak
    return out


def merge_timeline(payloads: Dict[str, dict],
                   skew: Optional[Dict[str, dict]] = None
                   ) -> Optional[dict]:
    """Fold per-host published step spans (``payload["spans"]``, see
    ``Telemetry.payload``) into ONE cluster-wide Perfetto/Chrome-trace
    timeline: one pid per host, host monotonic clocks aligned onto the
    first publishing host's via each payload's (mono, wall)
    ``clock_anchor`` pair, and the per-host step-time skew (vs the
    cluster median) stamped on each host's process metadata.  None
    when no host published spans."""
    skew = skew if skew is not None else host_skew(payloads)
    hosts = [h for h in sorted(payloads)
             if (payloads[h] or {}).get("spans")]
    if not hosts:
        return None
    ref_anchor = (payloads[hosts[0]].get("clock_anchor") or {})
    ref_delta = (ref_anchor.get("wall", 0.0)
                 - ref_anchor.get("mono", 0.0))
    events = []
    for pid, host in enumerate(hosts, start=1):
        payload = payloads[host]
        anchor = payload.get("clock_anchor") or {}
        offset = ((anchor.get("wall", 0.0) - anchor.get("mono", 0.0))
                  - ref_delta) if anchor and ref_anchor else 0.0
        meta = {"name": host, "host": host}
        if host in (skew or {}):
            meta["step_time_skew"] = skew[host].get("skew")
            meta["mean_step_s"] = skew[host].get("mean_step_s")
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": meta})
        for sp in payload.get("spans", ()):
            args = dict(sp.get("args") or {})
            args["host"] = host
            events.append({
                "name": sp["name"], "cat": sp["cat"], "ph": "X",
                "ts": (sp["start"] + offset) * 1e6,
                "dur": sp["dur"] * 1e6,
                "pid": pid, "tid": sp.get("tid", 0), "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "hosts": hosts}


def merge_cluster(payloads: Dict[str, dict]) -> dict:
    """Fold per-host telemetry payloads (host → the dict
    ``Telemetry.payload()`` publishes) into the one cluster view the
    run report renders."""
    hosts = sorted(payloads)
    goodput = GoodputLedger.merge_snapshots(
        [p.get("goodput") or {} for p in payloads.values()])
    spans: Dict[str, float] = {}
    for p in payloads.values():
        for cat, secs in (p.get("span_totals") or {}).items():
            spans[cat] = spans.get(cat, 0.0) + float(secs)
    skew = host_skew(payloads)
    # per-tenant serving fold (multi-tenant fleets: each replica's
    # "serving" section carries a tenants map — counters sum)
    tenants: Dict[str, dict] = {}
    for p in payloads.values():
        for t, rec in ((p.get("serving") or {}).get("tenants")
                       or {}).items():
            agg = tenants.setdefault(
                t, {"requests": {}, "sheds": {}, "total": 0,
                    "served_ok": 0, "shed_total": 0})
            for status, n in (rec.get("requests") or {}).items():
                agg["requests"][status] = \
                    agg["requests"].get(status, 0) + int(n)
            for reason, n in (rec.get("sheds") or {}).items():
                agg["sheds"][reason] = \
                    agg["sheds"].get(reason, 0) + int(n)
            for key in ("total", "served_ok", "shed_total"):
                agg[key] += int(rec.get(key) or 0)
    return {
        "hosts": hosts,
        "incarnation": max(
            (int(p.get("incarnation", 0)) for p in payloads.values()),
            default=0),
        "goodput": goodput,
        "metrics": merge_metrics(
            [p.get("metrics") or {} for p in payloads.values()]),
        "span_totals": dict(sorted(spans.items())),
        # per-tenant serving outcomes (empty on single-model fleets /
        # training-only runs) — the run report renders the table
        "tenants": dict(sorted(tenants.items())),
        "per_host_skew": skew,
        "perf": merge_perf(payloads),
        # the cluster-wide Perfetto timeline (None when no host
        # published spans — the payloads' span export is bounded)
        "timeline": merge_timeline(payloads, skew=skew),
        # the cluster alert view (None when no host runs an SLO
        # engine) — the run report renders it with alerts=True
        "alerts": merge_alerts(payloads),
        # the cluster incident view (None when no host runs an
        # incident engine)
        "incidents": merge_incidents(payloads),
    }
