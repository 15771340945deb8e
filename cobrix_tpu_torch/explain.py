"""Scan explain: the structured "what will this read do / what did it
cost" report.

Two entry points:

* ``explain(copybook=..., **options)`` — PRE-scan: parses the copybook,
  compiles the field plan, and reports the decode program (per-field
  offsets/widths/codecs, kernel-group shape), the execution plan the
  options select, and the warm/cold state of every cache plane — with
  NO data file required (``path`` is optional and only adds file
  listing/size information).
* ``read_cobol(..., explain=True)`` — POST-scan: the same report plus
  the measured per-field cost table (obs.fieldcost; attribution is
  forced on for the read), the read's metrics, and the roofline
  anchoring (obs.roofline) per the decode-throughput law. The decoded
  result rides on ``report.data``.

`ScanReport.render()` is the human view; `as_dict()` the structured
one; `top_fields(n)` the "which columns should I optimize" answer the
SIMD / late-materialization roadmap items need.

Port copy of ``cobrix_tpu.explain``. Changes: `explain` takes `device`
where the JAX package's takes `backend`, and the execution plan names
the device (``"device"``) where the JAX package names the backend; like
every entry point of the port it resolves the device first, so it
defaults to the card and raises without one unless given
``device="cpu"``. It reads the copybook, compiles the plan and looks up
the code page's table, all on the host: it launches no kernel. The
encoding options the port's `read_cobol` takes as arguments
(`ebcdic_code_page`, `schema_retention_policy`, `string_trimming_policy`,
`floating_point_format`) are taken here as keywords. `hosts` is always
1 (ROADMAP A7).
"""
from __future__ import annotations

from typing import List, Optional

# cache plane -> (hits key, misses key) in the plan-cache stat dicts
_PLAN_CACHE_PLANES = (
    ("copybook_parse", "parse_hits", "parse_misses"),
    ("field_plan", "plan_hits", "plan_misses"),
    ("code_page_lut", "lut_hits", "lut_misses"),
    ("decoder", "decoder_hits", "decoder_misses"),
)


def _plane_status(hits: int, misses: int) -> str:
    if hits:
        return "hit"
    if misses:
        return "miss"
    return "cold"


def _cache_planes(plan_cache: Optional[dict], io: Optional[dict],
                  cache_dir: str) -> dict:
    """Per-plane {hits, misses, status} rows: the four compile planes
    (plan/cache.py) plus the persistent block/index planes (cobrix_tpu
    .io — 'off' when no cache_dir is configured)."""
    stats = plan_cache or {}
    planes = {}
    for name, hk, mk in _PLAN_CACHE_PLANES:
        h, m = int(stats.get(hk, 0)), int(stats.get(mk, 0))
        planes[name] = {"hits": h, "misses": m,
                        "status": _plane_status(h, m)}
    io = io or {}
    for plane in ("block", "index"):
        if not cache_dir:
            planes[plane] = {"hits": 0, "misses": 0, "status": "off"}
            continue
        h = int(io.get(f"{plane}_hits", 0))
        m = int(io.get(f"{plane}_misses", 0))
        planes[plane] = {"hits": h, "misses": m,
                         "status": _plane_status(h, m)}
    return planes


class ScanReport:
    """The explain artifact: field plan + execution plan + cache-plane
    status, and (post-scan) measured per-field costs and roofline."""

    def __init__(self, copybook_summary: dict, fields: List[dict],
                 groups: List[dict], plan: dict, cache_planes: dict,
                 data=None, metrics=None, pushdown=None, stats=None):
        self.copybook = copybook_summary
        self.fields = fields          # FieldPlan.describe() rows
        self.groups = groups          # FieldPlan.group_summary() rows
        self.plan = plan              # execution-plan dict
        self.cache_planes = cache_planes
        self.data = data              # CobolData (post-scan only)
        self.metrics = metrics        # ReadMetrics (post-scan only)
        # query-pushdown section (query/pushdown.describe_pushdown):
        # retained vs pruned fields, per-depth decisions, the
        # late-materialized set — None when no select/filter configured
        self.pushdown = pushdown
        # per-file profile summaries (stats/profile.FileProfile.summary)
        # when the read collected statistics (collect_stats=true)
        self.stats = stats

    # -- measured costs (post-scan) --------------------------------------

    @property
    def field_costs(self) -> Optional[dict]:
        """Live {field -> {kernel, decode_s, assemble_s, busy_s, bytes,
        values, calls}} table; None pre-scan / attribution off. Live on
        purpose: Arrow assembly after the read (sequential `to_arrow`)
        keeps accruing into the same table."""
        if self.metrics is None:
            return None
        return self.metrics.field_costs

    def decode_busy_s(self) -> Optional[float]:
        """The read's decode-STAGE busy seconds (profiling.StageTimes),
        the total the per-field decode attribution should track."""
        if self.metrics is None or self.metrics.stage_busy is None:
            return None
        return self.metrics.stage_busy.as_dict().get("decode")

    def attributed_decode_s(self) -> Optional[float]:
        acc = getattr(self.metrics, "field_costs_acc", None) \
            if self.metrics is not None else None
        if acc is None:
            return None
        return acc.decode_busy_s()

    def top_fields(self, n: int = 5) -> List[dict]:
        """The N most expensive fields ({field, kernel, busy_s, ...}),
        by total busy seconds; [] when no costs were measured."""
        from .obs.fieldcost import top_fields as _top

        costs = self.field_costs
        return _top(costs, n) if costs else []

    @property
    def roofline(self) -> Optional[dict]:
        """{'bandwidth_GBps', 'achieved_MBps', 'fraction'} against the
        cached calibration (obs.roofline); pre-scan reports just the
        calibrated bandwidth when one exists."""
        if self.metrics is not None:
            roof = self.metrics.roofline()
            if roof is not None:
                return roof
        from .obs.roofline import cached_bandwidth

        bw = cached_bandwidth()
        if bw is None:
            return None
        return {"bandwidth_GBps": round(bw / 1e9, 2)}

    # -- serialization ----------------------------------------------------

    def as_dict(self) -> dict:
        out = {
            "copybook": self.copybook,
            "fields": self.fields,
            "kernel_groups": self.groups,
            "plan": self.plan,
            "cache_planes": self.cache_planes,
        }
        if self.pushdown is not None:
            out["pushdown"] = self.pushdown
        if self.stats is not None:
            out["statistics"] = self.stats
        if (self.metrics is not None
                and self.metrics.pushdown is not None):
            out.setdefault("pushdown", {})
            out["pushdown"] = dict(out["pushdown"],
                                   measured=self.metrics.pushdown)
        roof = self.roofline
        if roof is not None:
            out["roofline"] = roof
        costs = self.field_costs
        if costs is not None:
            out["field_costs"] = costs
            out["top_fields"] = self.top_fields(5)
            decode_stage = self.decode_busy_s()
            if decode_stage:
                out["decode_stage_busy_s"] = round(decode_stage, 6)
                out["decode_attributed_s"] = round(
                    self.attributed_decode_s() or 0.0, 6)
        if self.metrics is not None:
            out["records"] = self.metrics.records
            out["bytes_read"] = self.metrics.bytes_read
        return out

    def render(self, top_n: int = 10) -> str:
        """Terminal view of the report."""
        cb = self.copybook
        lines = [
            f"copybook: record_size={cb['record_size']} B, "
            f"{cb['fields']} field(s), {cb['kernel_groups']} kernel "
            f"group(s), code page '{cb['code_page']}'",
            "plan: " + ", ".join(f"{k}={v}"
                                 for k, v in self.plan.items()),
            "cache planes: " + " ".join(
                f"{name}={row['status']}"
                for name, row in self.cache_planes.items()),
        ]
        pd = self.pushdown
        if pd is not None:
            line = (f"pushdown: {pd['fields_retained']}/"
                    f"{pd['fields_total']} fields retained "
                    f"({pd['fields_pruned']} pruned from the plan)")
            if pd.get("filter"):
                line += f"; filter: {pd['filter']}"
            lines.append(line)
            depths = []
            if pd.get("pre_decode_segment_drop"):
                depths.append("segment-id drop on raw bytes "
                              f"({','.join(pd['pre_decode_segment_drop'])})")
            if pd.get("stage1_filter_fields"):
                depths.append("stage-1 decode of "
                              + ",".join(pd["stage1_filter_fields"]))
            if pd.get("residual"):
                depths.append(f"post-decode residual: {pd['residual']}")
            if depths:
                lines.append("  depths: " + "; ".join(depths))
            if pd.get("late_materialized"):
                lines.append("  late-materialized (decoded for the "
                             "predicate, not assembled): "
                             + ",".join(pd["late_materialized"]))
            measured = (self.metrics.pushdown
                        if self.metrics is not None else None)
            if measured:
                lines.append(
                    f"  measured: {measured['records_pruned']}/"
                    f"{measured['records_scanned']} records pruned, "
                    f"{measured['bytes_skipped']} bytes skipped, "
                    f"selectivity {measured['selectivity']}")
        stats = self.stats
        if stats:
            lines.append(f"statistics: {len(stats)} file profile(s) "
                         "collected")
            for url, prof in list(stats.items())[:3]:
                lines.append(
                    f"  {url}: {prof['chunks']} chunk(s), "
                    f"{prof['records']} record(s), "
                    f"{len(prof['fields'])} profiled field(s)")
        measured_skips = (self.metrics.pushdown
                         if self.metrics is not None else None) or {}
        if measured_skips.get("chunks_considered"):
            lines.append(
                f"chunk skipping: {measured_skips['chunks_skipped']}/"
                f"{measured_skips['chunks_considered']} chunk(s) "
                "proven no-match and dropped before framing")
        roof = self.roofline
        if roof is not None:
            line = f"roofline: {roof['bandwidth_GBps']} GB/s calibrated"
            if "fraction" in roof:
                line += (f"; scan achieved {roof['achieved_MBps']} MB/s"
                         f" = {roof['fraction'] * 100:.1f}% of bandwidth")
            lines.append(line)
        else:
            lines.append("roofline: uncalibrated (run bench.py or "
                         "obs.roofline.measured_bandwidth())")
        costs = self.field_costs
        if costs:
            decode_total = sum(r["decode_s"] for r in costs.values())
            stage = self.decode_busy_s()
            head = (f"field costs (top {min(top_n, len(costs))} of "
                    f"{len(costs)}")
            if stage:
                head += (f"; decode stage {stage:.3f}s, "
                         f"{decode_total / stage * 100:.0f}% attributed")
            lines.append(head + "):")
            lines.append(f"  {'field':<24} {'kernel':<20} {'busy_s':>8} "
                         f"{'MB':>8} {'MB/s':>8} {'%decode':>8}")
            for name, row in list(costs.items())[:top_n]:
                mb = row["bytes"] / (1024 * 1024)
                mbps = (mb / row["busy_s"]) if row["busy_s"] > 0 else 0.0
                pct = (row["decode_s"] / decode_total * 100
                       if decode_total > 0 else 0.0)
                lines.append(
                    f"  {name:<24} {row['kernel']:<20} "
                    f"{row['busy_s']:>8.4f} {mb:>8.2f} {mbps:>8.1f} "
                    f"{pct:>7.1f}%")
        else:
            lines.append("field costs: not measured (run with "
                         "explain=True / field_costs=true)")
        return "\n".join(lines)

    def __repr__(self) -> str:  # the REPL view IS the report
        return self.render()


def _copybook_summary(copybook, plan) -> dict:
    return {
        "record_size": copybook.record_size,
        "fields": len(plan.describe()),
        "columns": len(plan.columns),
        "kernel_groups": len(plan.groups),
        "code_page": copybook.ebcdic_code_page,
    }


def _execution_plan(params, files: List[str], total_bytes: int,
                    device: str, hosts: int) -> dict:
    mode = ("variable-length" if params.needs_var_len_reader
            else "fixed-length")
    plan = {
        "mode": mode,
        "device": device,
        "pipeline_workers": params.resolved_pipeline_workers(),
        "chunk_mb": params.pipeline_chunk_mb,
        "hosts": max(hosts, 1),
        "files": len(files),
        "total_bytes": total_bytes,
    }
    if params.select:
        plan["select"] = list(params.select)
    if getattr(params, "filter", None):
        from .query.expr import from_wire

        plan["filter"] = str(from_wire(params.filter))
    if mode == "fixed-length" and total_bytes:
        chunk_bytes = max(1, int(params.pipeline_chunk_mb * 1024 * 1024))
        plan["est_chunks"] = max(1, -(-total_bytes // chunk_bytes))
    elif mode == "variable-length":
        plan["chunking"] = "sparse-index driven"
    if params.cache_dir:
        plan["cache_dir"] = params.cache_dir
    return plan


def explain(copybook: Optional[str] = None,
            copybook_contents=None,
            path=None,
            device=None,
            calibrate: bool = False,
            **options) -> ScanReport:
    """Pre-scan explain: what the decode program and execution plan for
    these options look like, without reading any data (``path`` is
    optional; when given, files are listed and sized for the plan).
    `calibrate=True` runs the roofline calibration if the machine has
    never calibrated (~1s, cached on disk). `device=None` is the card
    (RuntimeError without one); ``device="cpu"`` for the plain
    versions."""
    from .api import _total_input_bytes, list_input_files, parse_options
    from .device import resolve_device
    from .plan.cache import (
        CacheStatsScope,
        activate_scope,
        cached_compile_plan,
        copybook_for_params,
        deactivate_scope,
    )

    if copybook is not None and copybook_contents is not None:
        raise ValueError("Both 'copybook' and 'copybook_contents' options "
                         "cannot be specified at the same time")
    if copybook_contents is None:
        if copybook is None:
            raise ValueError(
                "COPYBOOK is not provided. Please, provide either "
                "'copybook' path or 'copybook_contents'.")
        books = ([copybook] if isinstance(copybook, str)
                 else list(copybook))
        contents = []
        for b in books:
            with open(b, encoding="utf-8") as f:
                contents.append(f.read())
        copybook_contents = contents if len(contents) > 1 else contents[0]

    device = resolve_device(device)
    options = dict(options)
    encodings = {k: options.pop(k) for k in (
        "ebcdic_code_page", "schema_retention_policy",
        "string_trimming_policy", "floating_point_format")
        if k in options}
    params = parse_options(options, **encodings)
    hosts = 1
    files = list_input_files(path) if path is not None else []
    total_bytes = _total_input_bytes(files) if files else 0

    # observe THIS explain call's own cache traffic: a warm process
    # reports hit/hit/hit, a cold one miss — exactly what a scan next
    # would experience
    scope = CacheStatsScope()
    prev = activate_scope(scope)
    try:
        copybook_obj = copybook_for_params(copybook_contents, params)
        plan = cached_compile_plan(copybook_obj, None,
                                   select=params.select)
        from .plan.cache import cached_code_page_lut

        cached_code_page_lut(copybook_obj.ebcdic_code_page)
    finally:
        deactivate_scope(prev)

    if calibrate:
        from .obs.roofline import measured_bandwidth

        measured_bandwidth()
    from .query.pushdown import describe_pushdown

    return ScanReport(
        copybook_summary=_copybook_summary(copybook_obj, plan),
        fields=plan.describe(),
        groups=plan.group_summary(),
        plan=_execution_plan(params, files, total_bytes, str(device),
                             hosts),
        cache_planes=_cache_planes(dict(scope.stats), None,
                                   params.cache_dir),
        pushdown=describe_pushdown(copybook_obj, params),
    )


def build_scan_report(params, files: List[str], data,
                      device) -> ScanReport:
    """Post-scan report for `read_cobol(..., explain=True)`: the static
    plan description plus the read's measured metrics/costs."""
    from .plan.cache import cached_compile_plan

    metrics = data.metrics
    copybook_obj = data.output_schema.copybook
    # plan-cache hit by construction (the read compiled it); describes
    # the whole layout (active_segment=None) like the pre-scan report
    plan = cached_compile_plan(copybook_obj, None, select=params.select)
    from .query.pushdown import describe_pushdown

    return ScanReport(
        copybook_summary=_copybook_summary(copybook_obj, plan),
        fields=plan.describe(),
        groups=plan.group_summary(),
        plan=_execution_plan(params, files, metrics.bytes_read,
                             str(device), metrics.hosts),
        cache_planes=_cache_planes(metrics.plan_cache, metrics.io,
                                   params.cache_dir),
        data=data,
        metrics=metrics,
        pushdown=describe_pushdown(copybook_obj, params),
        stats=getattr(data, "stats_profiles", None),
    )
