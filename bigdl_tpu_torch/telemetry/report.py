"""Run-report rendering: a text table answering "where did the time
go?" from a snapshot directory (or an already-merged cluster view).

Callers hand it in-memory payloads or a folded snapshot directory.
Its text is the JAX package's, headings included, so one report reads
either package's payloads; the port's "performance" section shows the
counted work of ``telemetry/perf.py``.
"""
from __future__ import annotations

from typing import Dict, List

from .aggregate import merge_cluster, read_snapshot_dir

__all__ = ["render_report", "report_from_dir"]


def _bar(frac: float, width: int = 24) -> str:
    n = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * n + "." * (width - n)


def render_report(cluster: dict, top_n: int = 6,
                  alerts: bool = False) -> str:
    """Text run report from a merged cluster view
    (:func:`~.aggregate.merge_cluster`): goodput breakdown, top span
    categories, per-host step-time skew.  ``alerts=True`` adds the
    active/fired SLO alert table next to the goodput ledger."""
    lines: List[str] = []
    hosts = cluster.get("hosts") or []
    gp = cluster.get("goodput") or {}
    wall = float(gp.get("wall_s") or 0.0)
    lines.append("================ bigdl_tpu run report ================")
    lines.append(f"hosts: {len(hosts)} ({', '.join(hosts)})  "
                 f"incarnation: {cluster.get('incarnation', 0)}")
    lines.append(f"wall clock (host-seconds): {wall:.2f}s   "
                 f"goodput: {100.0 * float(gp.get('productive_fraction') or 0.0):.1f}%   "
                 f"accounted: {100.0 * float(gp.get('accounted_fraction') or 0.0):.1f}%")
    lines.append("")
    lines.append("-- goodput ledger ------------------------------------")
    secs: Dict[str, float] = gp.get("seconds") or {}
    for cat, s in sorted(secs.items(), key=lambda kv: -kv[1]):
        frac = s / wall if wall > 0 else 0.0
        lines.append(f"  {cat:<12} {s:>10.2f}s  {100 * frac:>5.1f}%  "
                     f"|{_bar(frac)}|")
    if alerts:
        lines.extend(_render_alerts(cluster.get("alerts")))
    spans: Dict[str, float] = cluster.get("span_totals") or {}
    if spans:
        lines.append("")
        lines.append(f"-- top span categories (of {len(spans)}) "
                     "-----------------------")
        total = sum(spans.values()) or 1.0
        for cat, s in sorted(spans.items(),
                             key=lambda kv: -kv[1])[:top_n]:
            lines.append(f"  {cat:<12} {s:>10.2f}s  "
                         f"{100 * s / total:>5.1f}%")
    tenants = cluster.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append("-- per-tenant serving --------------------------------")
        for t, rec in sorted(tenants.items()):
            total = int(rec.get("total") or 0)
            ok = int(rec.get("served_ok") or 0)
            shed = int(rec.get("shed_total") or 0)
            reasons = ", ".join(
                f"{r}={n}" for r, n
                in sorted((rec.get("sheds") or {}).items()))
            lines.append(
                f"  {t:<12} {total:>8} req  ok {ok:>8}  "
                f"shed {shed:>6}" + (f"  ({reasons})" if reasons
                                     else ""))
    skew = cluster.get("per_host_skew") or {}
    if skew:
        lines.append("")
        lines.append("-- per-host step-time skew ---------------------------")
        for host, rec in skew.items():
            lines.append(
                f"  {host:<12} mean step "
                f"{1e3 * float(rec.get('mean_step_s') or 0.0):>8.2f}ms"
                f"   {float(rec.get('skew') or 0.0):>5.2f}x median")
    perf = cluster.get("perf")
    if perf:
        lines.extend(_render_perf(perf))
    lines.append("======================================================")
    return "\n".join(lines)


def _render_alerts(alerts) -> List[str]:
    """The SLO alert section (:func:`~.aggregate.merge_alerts`
    output): cluster verdict, the active-alert table, and recent
    firing/resolved transitions in time order."""
    lines: List[str] = [""]
    lines.append("-- slo alerts ----------------------------------------")
    if not alerts:
        lines.append("  no host published an SLO engine snapshot")
        return lines
    totals = alerts.get("totals") or {}
    lines.append(
        f"  verdict: {alerts.get('verdict', 'ok')}   "
        f"active: {len(alerts.get('active') or ())}   "
        f"fired: {totals.get('firing', 0)}   "
        f"resolved: {totals.get('resolved', 0)}")
    active = alerts.get("active") or []
    if active:
        lines.append(f"  {'rule':<32} {'sev':<7} {'host':<10} value")
        for a in active:
            val = a.get("value")
            val_s = (f"{val:.4g}" if isinstance(val, (int, float))
                     else "n/a")
            lines.append(f"  {a.get('rule', '?'):<32} "
                         f"{a.get('severity', '?'):<7} "
                         f"{a.get('host', '?'):<10} {val_s}")
    recent = alerts.get("recent") or []
    if recent:
        lines.append(f"  recent transitions ({len(recent)}):")
        for a in recent[-10:]:
            lines.append(
                f"    [{a.get('state', '?'):<8}] "
                f"{a.get('rule', '?'):<32} {a.get('reason', '')}")
    return lines


def _human_flops(v: float) -> str:
    for unit, scale in (("PF", 1e15), ("TF", 1e12), ("GF", 1e9),
                        ("MF", 1e6)):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {unit}"
    return f"{v:.0f} F"


def _human_bytes(v: float) -> str:
    for unit, scale in (("GiB", 1024 ** 3), ("MiB", 1024 ** 2),
                        ("KiB", 1024)):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {unit}"
    return f"{v:.0f} B"


def _render_perf(perf: dict) -> List[str]:
    """The performance section: cluster MFU next to the goodput
    ledger, and the per-program roofline table."""
    lines: List[str] = [""]
    lines.append("-- performance (XLA cost model) ----------------------")
    dev = perf.get("device") or {}
    mfu = perf.get("cluster_mfu")
    head = "  cluster MFU: " + (f"{100 * mfu:.1f}%" if mfu is not None
                                else "n/a")
    head += f"   total flops: {_human_flops(perf.get('flops_total') or 0.0)}"
    if dev.get("peak_flops_per_sec"):
        head += (f"   peak/chip: "
                 f"{dev['peak_flops_per_sec'] / 1e12:.4g} TFLOP/s "
                 f"({dev.get('kind', '?')})")
    if perf.get("nominal_device"):
        head += "   [nominal peak]"
    lines.append(head)
    hbm = perf.get("hbm_peak_bytes")
    if hbm is not None:
        lines.append(f"  hbm peak: {_human_bytes(hbm)}")
    programs = perf.get("programs") or {}
    if programs:
        lines.append(f"  {'program':<24} {'flops/step':>10} "
                     f"{'bytes/step':>10} {'intensity':>9} "
                     f"{'mfu':>6}  bound")
        for label, prog in sorted(programs.items()):
            ai = prog.get("arithmetic_intensity")
            pmfu = prog.get("mfu")
            lines.append(
                f"  {label:<24} "
                f"{_human_flops(prog.get('flops') or 0.0):>10} "
                f"{_human_bytes(prog.get('bytes_accessed') or 0.0):>10} "
                f"{(f'{ai:.1f}' if ai is not None else 'n/a'):>9} "
                f"{(f'{100 * pmfu:.1f}%' if pmfu is not None else 'n/a'):>6}"
                f"  {prog.get('bound', 'unknown')}-bound")
    return lines


def report_from_dir(directory: str, top_n: int = 6) -> str:
    """Render the report for a snapshot directory (one ``<host>.json``
    per host, as written by ``Telemetry.write_snapshot``)."""
    payloads = read_snapshot_dir(directory)
    if not payloads:
        return f"no telemetry snapshots found under {directory!r}"
    return render_report(merge_cluster(payloads), top_n=top_n)
