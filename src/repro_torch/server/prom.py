"""Prometheus text-format exposition for the gateway's ``/metrics``.

Pure rendering: takes an incremental ``ClusterReport`` snapshot, a
``TelemetryHub.snapshot()`` dict (the live sliding window), and the
gateway's own HTTP counters; emits the text format a Prometheus scraper
ingests. Empty or still-warming windows simply omit their series
(NaN/None values are skipped, never rendered).
"""
from __future__ import annotations

import math
from typing import Dict, List


def _ok(v) -> bool:
    return v is not None and isinstance(v, (int, float)) \
        and math.isfinite(v)


def _fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


class _Writer:
    def __init__(self):
        self.lines: List[str] = []

    def metric(self, name: str, mtype: str, help_text: str,
               samples: List) -> None:
        """``samples`` is a list of (labels_dict_or_None, value); the
        whole family is omitted when no sample survives the NaN/None
        filter."""
        kept = [(labels, v) for labels, v in samples if _ok(v)]
        if not kept:
            return
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")
        for labels, v in kept:
            if labels:
                lab = ",".join(f'{k}="{val}"'
                               for k, val in sorted(labels.items()))
                self.lines.append(f"{name}{{{lab}}} {_fmt(v)}")
            else:
                self.lines.append(f"{name} {_fmt(v)}")

    def histogram(self, name: str, help_text: str, snap) -> None:
        """Render a ``Histogram.to_dict()`` snapshot as a real
        Prometheus ``histogram`` family: cumulative ``_bucket{le=...}``
        series plus ``_sum``/``_count``. Empty (or absent) histograms
        are omitted entirely, matching ``metric``'s behavior."""
        if not snap or not snap.get("count"):
            return
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} histogram")
        for le, cum in snap["buckets"]:
            le_s = le if isinstance(le, str) else _fmt(float(le))
            self.lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
        self.lines.append(f"{name}_sum {_fmt(float(snap['sum']))}")
        self.lines.append(f"{name}_count {snap['count']}")

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_metrics(report, telemetry: Dict,
                   gateway: Dict) -> str:
    """Render one scrape. ``report`` is a (possibly mid-flight)
    ``ClusterReport``; ``telemetry`` a ``TelemetryHub.snapshot``;
    ``gateway`` the gateway's counter dict (http codes, streamed
    tokens, admission rejections, state)."""
    w = _Writer()
    # -- gateway-level ---------------------------------------------------
    w.metric("repro_gateway_up", "gauge", "1 while serving, 0 draining",
             [(None, 1 if gateway.get("state") == "serving" else 0)])
    w.metric("repro_gateway_requests_total", "counter",
             "HTTP responses by status code",
             [({"code": str(code)}, n)
              for code, n in sorted(gateway.get("codes", {}).items())])
    w.metric("repro_gateway_streamed_tokens_total", "counter",
             "Tokens delivered over SSE streams",
             [(None, gateway.get("streamed_tokens", 0))])
    w.metric("repro_gateway_admission_rejected_total", "counter",
             "Requests refused by per-tenant admission control",
             [({"tenant": t, "reason": "any"}, n)
              for t, n in sorted(gateway.get("rejected", {}).items())])
    w.metric("repro_gateway_open_streams", "gauge",
             "SSE streams currently open",
             [(None, gateway.get("open_streams", 0))])
    w.metric("repro_gateway_client_disconnects_total", "counter",
             "Streams cancelled because the client went away",
             [(None, gateway.get("disconnects", 0))])
    # -- cluster state ---------------------------------------------------
    w.metric("repro_cluster_pending", "gauge",
             "Requests queued or running across all servers",
             [(None, report.in_progress)])
    w.metric("repro_cluster_servers", "gauge",
             "Active (placeable) servers",
             [(None, report.final_servers)])
    w.metric("repro_cluster_completed_total", "counter",
             "Requests finished since start",
             [(None, report.completed())])
    w.metric("repro_cluster_timed_out_total", "counter",
             "Requests dropped by the admission timeout",
             [(None, report.timed_out)])
    w.metric("repro_cluster_rebalances_total", "counter",
             "Periodic placement timesteps fired",
             [(None, report.rebalances)])
    w.metric("repro_cluster_adapter_fetches_total", "counter",
             "Miss-driven adapter fetches",
             [(None, report.fetches)])
    w.metric("repro_cluster_adapter_fetch_bytes_total", "counter",
             "Bytes moved by miss-driven fetches",
             [(None, report.fetch_bytes)])
    w.metric("repro_cluster_remote_reads_total", "counter",
             "Misses served via peer GDR remote reads",
             [(None, report.remote_reads)])
    w.metric("repro_cluster_prefetches_total", "counter",
             "Rebalance-driven proactive adapter warms",
             [(None, report.prefetches)])
    w.metric("repro_cluster_adapters_registered_total", "counter",
             "Adapters registered at runtime",
             [(None, report.registered)])
    w.metric("repro_cluster_adapters_unregistered_total", "counter",
             "Adapters retired at runtime (loss-free drains)",
             [(None, report.unregistered)])
    w.metric("repro_cluster_max_adapters_per_server", "gauge",
             "Peak HBM adapter count on any one server",
             [(None, report.max_adapters_per_server)])
    # -- whole-run latency (report percentiles are snapshot-safe) --------
    w.metric("repro_cluster_ttft_seconds", "gauge",
             "TTFT percentiles over all finished requests",
             [({"quantile": "0.5"}, report.p50_ttft()),
              ({"quantile": "0.95"}, report.p95_ttft())])
    w.metric("repro_cluster_tbt_seconds", "gauge",
             "Mean/P95 time-between-tokens over finished requests",
             [({"quantile": "mean"}, report.mean_tbt()),
              ({"quantile": "0.95"}, report.p95_tbt())])
    # -- live sliding window (TelemetryHub) ------------------------------
    w.metric("repro_window_ttft_seconds", "gauge",
             "Windowed TTFT percentiles (live sliding window)",
             [({"quantile": "0.5"}, telemetry.get("ttft_p50")),
              ({"quantile": "0.95"}, telemetry.get("ttft_p95"))])
    w.metric("repro_window_tbt_seconds", "gauge",
             "Windowed TBT percentiles (live sliding window)",
             [({"quantile": "0.5"}, telemetry.get("tbt_p50")),
              ({"quantile": "0.95"}, telemetry.get("tbt_p95"))])
    w.metric("repro_window_arrivals_total", "counter",
             "Requests routed since start",
             [(None, telemetry.get("arrivals"))])
    w.metric("repro_window_server_token_rate", "gauge",
             "Windowed per-server token throughput (tokens/s)",
             [({"server": str(sid)}, rate) for sid, rate in
              sorted(telemetry.get("server_token_rates", {}).items())])
    w.metric("repro_window_adapter_token_rate", "gauge",
             "Windowed per-adapter token demand (tokens/s)",
             [({"adapter": aid}, rate) for aid, rate in
              sorted(telemetry.get("adapter_token_rates", {}).items())])
    # -- cumulative latency histograms -----------------------------------
    w.histogram("repro_ttft_seconds",
                "TTFT distribution over all finished requests",
                telemetry.get("ttft_hist"))
    w.histogram("repro_tbt_seconds",
                "Time-between-tokens distribution over finished requests",
                telemetry.get("tbt_hist"))
    # -- cost-model drift (tracer-fed, empty without a tracer) -----------
    drift = getattr(report, "cost_drift", None) or {}
    w.metric("repro_costmodel_seconds_total", "counter",
             "Modeled vs measured phase time accumulated by the tracer",
             [({"phase": ph, "kind": kind}, d.get(f"{kind}_s"))
              for ph, d in sorted(drift.items())
              for kind in ("modeled", "measured")])
    w.metric("repro_costmodel_iterations_total", "counter",
             "Iteration spans paired with a cost-model prediction",
             [({"phase": ph}, d.get("count"))
              for ph, d in sorted(drift.items())])
    w.metric("repro_costmodel_drift_ratio", "gauge",
             "Signed (measured-modeled)/modeled bias per phase",
             [({"phase": ph}, d.get("bias"))
              for ph, d in sorted(drift.items())])
    w.metric("repro_costmodel_mean_abs_rel_err", "gauge",
             "Mean absolute relative error of the phase cost model",
             [({"phase": ph}, d.get("mean_abs_rel_err"))
              for ph, d in sorted(drift.items())])
    return w.render()
