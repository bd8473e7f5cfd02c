"""Heartbeat failure detector (the chaos plane's detection side).

Each live server beats once per host poll; a server silent for longer
than ``suspect_after`` is *suspected*, and one silent for ``window`` is
*confirmed dead* — at which point the host runs crash recovery
(``ClusterOrchestrator.fail_server`` + request re-dispatch).

The host beats every alive server and *then* calls ``check`` in the
same poll, so a virtual-clock jump can never outrun the beats of a
healthy server: false positives are structurally impossible — only a
server the host stopped beating (crashed in the backend) can be
confirmed.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class FailureDetector:
    def __init__(self, window: float = 0.5,
                 suspect_after: Optional[float] = None):
        if window <= 0:
            raise ValueError("detector window must be > 0")
        self.window = window
        self.suspect_after = (suspect_after if suspect_after is not None
                              else window / 2.0)
        self._last_beat: Dict[int, float] = {}
        self._confirmed: set = set()
        # telemetry
        self.confirmed_count = 0

    # -- host-facing ------------------------------------------------------
    def beat(self, server_id: int, now: float) -> None:
        if server_id in self._confirmed:
            return
        prev = self._last_beat.get(server_id, -float("inf"))
        self._last_beat[server_id] = max(prev, now)

    def remove(self, server_id: int) -> None:
        """Forget a server (retired, or recovery handled elsewhere)."""
        self._last_beat.pop(server_id, None)
        self._confirmed.discard(server_id)

    def restore(self, server_id: int, now: float) -> None:
        """A crashed server came back: start beating it afresh."""
        self._confirmed.discard(server_id)
        self._last_beat[server_id] = now

    def check(self, now: float) -> List[int]:
        """Newly confirmed-dead servers (silent >= ``window``). Each id
        is reported exactly once."""
        dead: List[int] = []
        for sid, t in sorted(self._last_beat.items()):
            if sid in self._confirmed:
                continue
            if now - t >= self.window - 1e-12:
                self._confirmed.add(sid)
                self.confirmed_count += 1
                dead.append(sid)
        return dead

    def suspects(self, now: float) -> List[int]:
        return [sid for sid, t in sorted(self._last_beat.items())
                if sid not in self._confirmed
                and now - t >= self.suspect_after - 1e-12]

    def confirmed(self) -> List[int]:
        return sorted(self._confirmed)

    def next_deadline(self, now: float) -> Optional[float]:
        """Earliest future time a tracked server could be confirmed —
        the host's event loop must wake by then for virtual clocks to
        reach detection."""
        times = [t + self.window for sid, t in self._last_beat.items()
                 if sid not in self._confirmed]
        if not times:
            return None
        return max(min(times), now)
