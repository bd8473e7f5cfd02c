"""Adapter-transfer model (paper Fig 14) with live link state.

Latency of fetching a tensor from local host memory, a remote server
over GPUDirect-RDMA/InfiniBand, or local SSD. The paper's observation:
IB GDR ~ local host->GPU latency; SSD is prohibitive. The TPU
deployment mapping (DESIGN.md §3) adds an "ici" source with v5e-class
inter-host bandwidth.

Beyond the flat Fig-14 table, the model now carries *link state* for the
adapter data plane (``repro.core.pool.AdapterStore``):

* every peer-sourced transfer occupies the source server's egress link
  until its ETA; concurrent transfers on one link divide bandwidth, so
  ``plan_latency`` quotes a load-dependent figure and the store picks
  the cheapest source instead of a hardcoded one;
* ``remote_read_penalty`` prices the GDR *remote-read* access mode: a
  request served from a peer's HBM copy streams adapter weights over
  the fabric every iteration until the local copy warms. Reads overlap
  compute (``remote_read_overlap``), so only the non-hidden fraction of
  the wire time is charged — the Fig-14 "IB GDR ~ local host" economics
  that make serving-before-migrating worthwhile.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

# bytes/s bandwidth and seconds of base latency per source
_SOURCES: Dict[str, tuple] = {
    # local host memory -> GPU over PCIe4 x16
    "local_host": (25e9, 50e-6),
    # remote host: src host->GPU copy then GPUDirect RDMA over 200Gb IB
    "ib_gdr": (22e9, 180e-6),
    # local NVMe SSD (the paper found this prohibitive)
    "ssd": (1.8e9, 120e-6),
    # TPU host-to-host over ICI (deployment mapping)
    "ici": (45e9, 60e-6),
}


class NetworkModel:
    """Transfer latency + per-link contention state.

    ``fabric`` names the peer-to-peer source ("ib_gdr" for the paper's
    GPU clusters, "ici" for the TPU deployment mapping); ``contention``
    is a global slowdown on all wire time (shared spine).
    """

    def __init__(self, contention: float = 1.0, fabric: str = "ib_gdr",
                 remote_read_overlap: float = 0.6):
        if fabric not in _SOURCES:
            raise ValueError(f"unknown fabric {fabric!r}")
        self.contention = contention
        self.fabric = fabric
        self.remote_read_overlap = remote_read_overlap
        # src_server -> ETAs of transfers currently leaving that server
        self._egress: Dict[int, List[float]] = {}
        # fault state (repro.faults): downed links quote infinite latency
        # and refuse new transfers; degraded links multiply wire time
        self._link_down: Set[int] = set()
        self._link_degrade: Dict[int, float] = {}

    def sources(self):
        return sorted(_SOURCES)

    # -- flat Fig-14 latency (no link state) ----------------------------
    def transfer_latency(self, nbytes: int, source: str) -> float:
        bw, lat = _SOURCES[source]
        return lat + self.contention * nbytes / bw

    # -- fault state (injected by repro.faults) --------------------------
    def set_link_down(self, src_server: int) -> None:
        """Flap a peer's egress link down: in-flight transfers keep
        their slots (the store's retry path re-sources them), but the
        link quotes infinite latency and refuses new transfers."""
        self._link_down.add(src_server)

    def set_link_up(self, src_server: int) -> None:
        self._link_down.discard(src_server)

    def degrade_link(self, src_server: int, factor: float) -> None:
        """Multiply the link's wire time by ``factor`` (>= 1); use
        ``reset_link`` / factor 1.0 to restore full bandwidth."""
        if factor < 1.0:
            raise ValueError(f"degrade factor {factor} < 1")
        self._link_degrade[src_server] = factor

    def reset_link(self, src_server: int) -> None:
        self._link_down.discard(src_server)
        self._link_degrade.pop(src_server, None)

    def link_up(self, src_server: int) -> bool:
        return src_server not in self._link_down

    def link_factor(self, src_server: int) -> float:
        return self._link_degrade.get(src_server, 1.0)

    # -- link state ------------------------------------------------------
    def link_load(self, src_server: int, now: float = 0.0) -> int:
        """Transfers currently in flight out of ``src_server``."""
        etas = self._egress.get(src_server)
        if not etas:
            return 0
        live = [t for t in etas if t > now + 1e-12]
        self._egress[src_server] = live
        return len(live)

    def plan_latency(self, nbytes: int, source: str, now: float = 0.0,
                     src_server: Optional[int] = None) -> float:
        """Quoted latency for a transfer starting at ``now``: base wire
        time scaled by how many transfers already share the source link
        (fair-share bandwidth division)."""
        if src_server is None:
            return self.transfer_latency(nbytes, source)
        if src_server in self._link_down:
            return float("inf")
        bw, lat = _SOURCES[source]
        load = self.link_load(src_server, now)
        factor = self._link_degrade.get(src_server, 1.0)
        return lat + factor * (1 + load) * self.contention * nbytes / bw

    def begin_transfer(self, nbytes: int, source: str, now: float = 0.0,
                       src_server: Optional[int] = None
                       ) -> Tuple[float, float]:
        """Start a transfer; returns (latency, eta) and — for peer
        sources — occupies the source's egress link until the ETA."""
        if src_server is not None and src_server in self._link_down:
            raise RuntimeError(f"transfer from downed link {src_server}")
        latency = self.plan_latency(nbytes, source, now, src_server)
        eta = now + latency
        if src_server is not None:
            self._egress.setdefault(src_server, []).append(eta)
        return latency, eta

    def end_transfer(self, src_server: int, eta: float) -> None:
        """Release the link slot of a completed transfer."""
        etas = self._egress.get(src_server)
        if etas and eta in etas:
            etas.remove(eta)

    def move_transfer(self, src_server: int, old_eta: float,
                      new_eta: float) -> None:
        """Re-time an occupied link slot (a stalled transfer keeps its
        slot, so link-occupancy accounting stays exact)."""
        etas = self._egress.get(src_server)
        if etas and old_eta in etas:
            etas.remove(old_eta)
            etas.append(new_eta)

    # -- remote-read access mode ----------------------------------------
    def remote_read_penalty(self, nbytes: int,
                            source: Optional[str] = None) -> float:
        """Per-iteration surcharge for executing with adapter weights
        resident on a peer: the fabric streams the adapter's bytes each
        iteration, overlapped with compute so only the non-hidden
        fraction is charged on top of the iteration time."""
        bw, lat = _SOURCES[source or self.fabric]
        hidden = max(0.0, min(1.0, self.remote_read_overlap))
        return lat + (1.0 - hidden) * self.contention * nbytes / bw
