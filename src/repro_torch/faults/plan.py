"""Deterministic fault schedules (the chaos plane's injection side).

A ``FaultPlan`` is a sorted list of ``FaultEvent``s on the host's clock
— the sim's virtual clock or the engine facade's wall clock; the same
plan replays identically on either substrate (and across runs: random
plans are seeded). Kinds:

* ``crash_server`` / ``restore_server`` — fail-stop a server (its HBM
  and host tiers vanish, in-flight work strands until recovery) and
  bring it back empty;
* ``link_down`` / ``link_up`` / ``link_degrade`` — flap or slow a
  peer's egress link in the ``NetworkModel`` (``arg`` is the wire-time
  multiplier for degrade);
* ``stall_fetch`` — freeze one in-flight ``AdapterStore`` transfer (or
  slow it by ``arg`` seconds) so the fetch timeout/retry path fires;
* ``disconnect_client`` — drop one live gateway SSE stream mid-flight
  (gateway hosts only; other hosts ignore it).
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import List, Optional, Sequence

KIND_CRASH = "crash_server"
KIND_RESTORE = "restore_server"
KIND_LINK_DOWN = "link_down"
KIND_LINK_UP = "link_up"
KIND_LINK_DEGRADE = "link_degrade"
KIND_STALL_FETCH = "stall_fetch"
KIND_DISCONNECT = "disconnect_client"

KINDS = (KIND_CRASH, KIND_RESTORE, KIND_LINK_DOWN, KIND_LINK_UP,
         KIND_LINK_DEGRADE, KIND_STALL_FETCH, KIND_DISCONNECT)


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    time: float
    kind: str
    target: int = -1     # server id / link id; -1: any (host picks)
    arg: float = 0.0     # degrade factor / stall seconds (0 = freeze)
    note: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """An ordered, replayable fault schedule with a consume cursor."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(events)
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.events)

    def add(self, event: FaultEvent) -> "FaultPlan":
        if self._cursor:
            raise RuntimeError("fault plan already partially consumed")
        self.events.append(event)
        self.events.sort()
        return self

    def due(self, now: float) -> List[FaultEvent]:
        """Consume and return every event scheduled at or before
        ``now`` (each event fires exactly once)."""
        out: List[FaultEvent] = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].time <= now + 1e-12):
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def next_time(self) -> Optional[float]:
        if self._cursor >= len(self.events):
            return None
        return self.events[self._cursor].time

    def remaining(self) -> int:
        return len(self.events) - self._cursor

    def reset(self) -> None:
        self._cursor = 0

    # -- serialization (launch/serve.py --fault-plan) -------------------
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([FaultEvent(**e) for e in json.loads(text)])

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    # -- scripted scenarios (chaos harness) -----------------------------
    @classmethod
    def kill_one(cls, t_kill: float, server: int,
                 t_restore: Optional[float] = None) -> "FaultPlan":
        """The canonical chaos scenario: fail-stop one server (and
        optionally bring it back)."""
        evs = [FaultEvent(t_kill, KIND_CRASH, server)]
        if t_restore is not None:
            evs.append(FaultEvent(t_restore, KIND_RESTORE, server))
        return cls(evs)

    @classmethod
    def link_flap(cls, t_down: float, server: int,
                  t_up: float) -> "FaultPlan":
        return cls([FaultEvent(t_down, KIND_LINK_DOWN, server),
                    FaultEvent(t_up, KIND_LINK_UP, server)])

    @classmethod
    def stall(cls, t: float, server: int = -1,
              extra: float = 0.0) -> "FaultPlan":
        """Freeze (or slow) whatever transfer is in flight at ``t``."""
        return cls([FaultEvent(t, KIND_STALL_FETCH, server, extra)])

    @classmethod
    def random_plan(cls, seed: int, horizon: float, n_servers: int,
                    rate: float = 0.2,
                    kinds: Sequence[str] = (KIND_CRASH, KIND_RESTORE,
                                            KIND_LINK_DOWN, KIND_LINK_UP,
                                            KIND_STALL_FETCH)
                    ) -> "FaultPlan":
        """A seeded Poisson fault storm. Crash/restore and down/up are
        paired per target so the cluster always heals: every crash gets
        a restore and every link-down a link-up inside the horizon."""
        rng = random.Random(seed)
        evs: List[FaultEvent] = []
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= horizon:
                break
            kind = rng.choice(list(kinds))
            target = rng.randrange(n_servers)
            if kind in (KIND_RESTORE, KIND_LINK_UP):
                continue            # pairs are emitted with their cause
            if kind == KIND_CRASH:
                evs.append(FaultEvent(t, KIND_CRASH, target))
                heal = min(horizon, t + rng.uniform(0.2, 1.0)
                           * (horizon - t))
                evs.append(FaultEvent(heal, KIND_RESTORE, target))
            elif kind == KIND_LINK_DOWN:
                evs.append(FaultEvent(t, KIND_LINK_DOWN, target))
                up = min(horizon, t + rng.uniform(0.05, 0.5)
                         * (horizon - t))
                evs.append(FaultEvent(up, KIND_LINK_UP, target))
            elif kind == KIND_LINK_DEGRADE:
                evs.append(FaultEvent(t, KIND_LINK_DEGRADE, target,
                                      rng.uniform(2.0, 8.0)))
            else:
                evs.append(FaultEvent(t, kind, target))
        return cls(evs)
