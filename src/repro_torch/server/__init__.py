"""Streaming serving surface: asyncio HTTP gateway over the
incremental ``LoRAServeCluster`` API (``repro_torch.server.gateway``; a copy of the
JAX package's ``server/``), with
minimal HTTP/1.1 + SSE framing (``http``), per-tenant admission control
(``admission``), and Prometheus text exposition (``prom``)."""
from .admission import AdmissionController, TokenBucket
from .gateway import ServeGateway
from .prom import render_metrics

__all__ = ["AdmissionController", "TokenBucket", "ServeGateway",
           "render_metrics"]
