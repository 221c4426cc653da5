"""Straggler mitigation for serving: hedged execution.

A copy of the JAX package's ``runtime/straggler.py``.  If a replica misses
its latency budget, the request is issued again on another replica and the
first answer wins (Dean's tail-at-scale recipe).  ``HedgedRouter``
implements the deadline and the hedge over replica backends that are plain
callables; no serving engine wires it, in the JAX package or here, so it is
held against JAX's with synthetic backends (``tests/test_torch_spill.py``).

Training cannot hedge a synchronous step: its mitigations (a watchdog that
restarts from a checkpoint, a re-layout that leaves the slow node out) come
with training (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class HedgeStats:
    issued: int = 0
    hedged: int = 0
    wins_primary: int = 0
    wins_hedge: int = 0
    p50_ms: float = 0.0
    latencies: list = field(default_factory=list)


class HedgedRouter:
    """Route a request to replica i; hedge to the next replica if the
    primary hasn't answered within ``hedge_after_s``."""

    def __init__(self, replicas: List[Callable], hedge_after_s: float):
        self.replicas = replicas
        self.hedge_after = hedge_after_s
        self.stats = HedgeStats()
        self._rr = 0

    def __call__(self, request):
        t0 = time.monotonic()
        primary = self.replicas[self._rr % len(self.replicas)]
        backup = self.replicas[(self._rr + 1) % len(self.replicas)]
        self._rr += 1
        self.stats.issued += 1

        result = {}
        done = threading.Event()

        def run(fn, who):
            try:
                r = fn(request)
            except Exception:      # noqa: BLE001 — failed replica = no answer
                return
            if not done.is_set():
                result[who] = r
                done.set()

        t1 = threading.Thread(target=run, args=(primary, "primary"),
                              daemon=True)
        t1.start()
        if not done.wait(self.hedge_after):
            self.stats.hedged += 1
            t2 = threading.Thread(target=run, args=(backup, "hedge"),
                                  daemon=True)
            t2.start()
            done.wait()
        if "primary" in result:
            self.stats.wins_primary += 1
            out = result["primary"]
        else:
            self.stats.wins_hedge += 1
            out = result["hedge"]
        self.stats.latencies.append(time.monotonic() - t0)
        return out
