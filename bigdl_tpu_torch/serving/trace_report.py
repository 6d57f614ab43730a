"""Critical-path analysis over stitched distributed request traces
(counterpart of the JAX repository's ``tools/trace_report.py``).

Input: ``{trace_id: <stitched Chrome trace>}`` (what
``ServingFleet.stitch_trace`` returns for each kept trace).  For every
trace :func:`analyze` computes, via
:func:`.request_trace.trace_attribution`:

* wall-clock coverage (span union / request wall, hedge losers
  excluded — duplicate duty never double-counts);
* seconds per phase — queue / batch / compute / kv / transport (the
  unattributed cross-process remainder) — and per-replica compute;
* the **critical-path phase** (argmax) and the busiest replica;

plus the p99-cohort table ("where does p99 live") and per-tenant
attribution (untagged traces under ``_default``).  :func:`render` prints
the report as text.
"""


def analyze(traces: dict) -> dict:
    """Per-trace attribution + the aggregate p99-cohort table."""
    from .request_trace import trace_attribution

    rows = []
    for tid, trace in sorted(traces.items()):
        attr = trace_attribution(trace)
        if attr is None:
            continue
        summary = trace.get("summary") or {}
        rows.append(dict(attr, trace_id=tid,
                         status=summary.get("status"),
                         reason=summary.get("reason")))
    if not rows:
        return {"traces": 0, "rows": [], "p99_cohort": None}
    walls = sorted(r["wall_s"] for r in rows)
    p99 = walls[min(len(walls) - 1, int(0.99 * (len(walls) - 1)))]
    cohort = [r for r in rows if r["wall_s"] >= p99]
    phases = {}
    by_replica = {}
    for r in cohort:
        for ph, s in r["phases"].items():
            phases[ph] = phases.get(ph, 0.0) + s
        for h, s in r["compute_by_replica"].items():
            by_replica[h] = by_replica.get(h, 0.0) + s
    dominant = max(((s, p) for p, s in phases.items()),
                   default=(0.0, None))[1]
    busiest = max(by_replica.items(), key=lambda kv: kv[1])[0] \
        if by_replica else None
    coverages = [r["coverage"] for r in rows
                 if r["coverage"] is not None]
    # per-tenant attribution (multi-tenant fleets stamp the tenant on
    # the root span): queue/compute/kv seconds + wall per tenant, so a
    # noisy-neighbor incident reads straight off kept traces
    tenants = {}
    for r in rows:
        # traces with no tenant stamp (single-model fleets, spans
        # predating multi-tenancy) land in the "_default" bucket —
        # attribution must never silently drop wall seconds
        t = r.get("tenant") or "_default"
        agg = tenants.setdefault(
            t, {"traces": 0, "wall_s": 0.0, "phase_seconds": {}})
        agg["traces"] += 1
        agg["wall_s"] += r["wall_s"]
        for ph, s in r["phases"].items():
            agg["phase_seconds"][ph] = \
                agg["phase_seconds"].get(ph, 0.0) + s
    for agg in tenants.values():
        agg["wall_s"] = round(agg["wall_s"], 6)
        agg["phase_seconds"] = {p: round(s, 6) for p, s
                                in sorted(agg["phase_seconds"].items())}
    return {
        "traces": len(rows),
        "rows": rows,
        "tenants": tenants,
        "coverage_min": round(min(coverages), 4) if coverages else None,
        "coverage_mean": round(sum(coverages) / len(coverages), 4)
        if coverages else None,
        "p99_cohort": {
            "wall_p99_s": round(p99, 6),
            "traces": len(cohort),
            "phase_seconds": {p: round(s, 6)
                              for p, s in sorted(phases.items())},
            "critical_phase": dominant,
            "critical_replica": busiest,
        },
    }


def render(report: dict, top: int = 10) -> str:
    lines = ["================ request trace report ================",
             "traces: %d   coverage min/mean: %s / %s" % (
                 report["traces"], report.get("coverage_min"),
                 report.get("coverage_mean"))]
    cohort = report.get("p99_cohort")
    if cohort:
        lines.append("")
        lines.append("-- where p99 lives (cohort of %d, wall >= %.3fms)"
                     % (cohort["traces"],
                        cohort["wall_p99_s"] * 1e3))
        total = sum(cohort["phase_seconds"].values()) or 1.0
        for ph, s in sorted(cohort["phase_seconds"].items(),
                            key=lambda kv: -kv[1]):
            lines.append("  %-10s %9.3fms  %5.1f%%"
                         % (ph, s * 1e3, 100.0 * s / total))
        lines.append("  critical path: %s (busiest replica: %s)"
                     % (cohort["critical_phase"],
                        cohort["critical_replica"]))
    tenants = report.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append("-- per-tenant attribution " + "-" * 28)
        for t, agg in sorted(tenants.items()):
            phases = " ".join(
                "%s=%.3fms" % (p, s * 1e3)
                for p, s in sorted(agg["phase_seconds"].items(),
                                   key=lambda kv: -kv[1])[:4])
            lines.append("  %-12s %3d trace(s)  wall %8.3fms  %s"
                         % (t, agg["traces"], agg["wall_s"] * 1e3,
                            phases))
    lines.append("")
    lines.append("-- slowest traces " + "-" * 36)
    rows = sorted(report["rows"], key=lambda r: -r["wall_s"])[:top]
    for r in rows:
        lines.append(
            "  %s  %8.3fms  cover %.2f  critical=%s on %s  [%s]"
            % (r["trace_id"][:16], r["wall_s"] * 1e3,
               r["coverage"] if r["coverage"] is not None else -1.0,
               r["critical_phase"], r["critical_replica"],
               r.get("reason") or r.get("status") or "?"))
    return "\n".join(lines)
