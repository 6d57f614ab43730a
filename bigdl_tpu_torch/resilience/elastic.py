"""Elastic membership: heartbeats, incarnations and the in-process KV
transport (counterpart of ``bigdl_tpu/resilience/elastic.py``, the part
of its membership half that the serving fleet runs on).

Every member publishes liveness through a pluggable :class:`KVTransport`
(:class:`InMemoryKV` for one process).  Membership is versioned by a
monotonically increasing **incarnation** number: incarnation *n* names an
exact member set, and every reconfiguration — shrink, eviction, regrow —
is a bump to *n+1*.  A departed member that comes back publishes a
``rejoin`` beat and is re-admitted at the next incarnation boundary.

The serving fleet (``serving/fleet.py``, ``serving/router.py``) runs its
replica membership on :class:`ElasticCoordinator` and :class:`InMemoryKV`.
Not ported yet, with the training elasticity that alone uses them: the
JAX module's ``FileKV``, ``BoundedLog``, ``MembershipChangedError``,
``StragglerPolicy``, ``largest_valid_shards``, ``ElasticContext``
(shrink-to-survivors training: checkpoint walk-back, mesh rebuild,
resume) and ``SimulatedHost``, and ``resilience/watchdog.py``;
``LocalOptimizer`` still refuses an elastic context.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..telemetry.events import record_change as _record_change

log = logging.getLogger("bigdl_tpu")

__all__ = ["ElasticCoordinator", "InMemoryKV", "KVTransport"]

# ---------------------------------------------------------------------------
# KV transports
# ---------------------------------------------------------------------------

class KVTransport:
    """Minimal shared-KV contract the membership protocol needs (a
    ``torch.distributed`` store could back it across processes);
    :class:`InMemoryKV` serves one process."""

    def put(self, key: str, value: str) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class InMemoryKV(KVTransport):
    """Dict-backed transport for single-process simulations (tests,
    single-process benches)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, str] = {}

    def put(self, key, value):
        with self._lock:
            self._data[str(key)] = str(value)

    def get(self, key):
        with self._lock:
            return self._data.get(str(key))

    def keys(self, prefix=""):
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key):
        with self._lock:
            self._data.pop(str(key), None)


# ---------------------------------------------------------------------------
# coordinator: heartbeats + incarnation-numbered membership
# ---------------------------------------------------------------------------

_HB = "hb/"
_INC = "inc"
_ACK = "ack/"
_EVICTED = "evicted/"


class ElasticCoordinator:
    """One host's handle on the cluster membership protocol.

    Keys (all JSON strings through the transport):

    * ``hb/<host>``      — ``{step, step_time, ts, rejoin}`` liveness beat
    * ``inc``            — ``{n, members, reason, by}`` current incarnation
    * ``ack/<n>/<host>`` — host has adopted incarnation ``n``
    * ``evicted/<host>`` — straggler eviction marker (cleared on readmit)

    ``ts`` uses this coordinator's ``clock`` — injectable so liveness
    tests need no real waiting.
    """

    def __init__(self, host: str, transport: KVTransport,
                 heartbeat_timeout: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.host = str(host)
        self.transport = transport
        self.heartbeat_timeout = float(heartbeat_timeout)
        self._clock = clock

    # -- liveness -------------------------------------------------------
    def heartbeat(self, step: int = 0, step_time: Optional[float] = None,
                  rejoin: bool = False):
        self.transport.put(_HB + self.host, json.dumps({
            "host": self.host, "step": int(step),
            "step_time": step_time, "ts": self._clock(),
            "rejoin": bool(rejoin)}))

    def beats(self) -> Dict[str, dict]:
        out = {}
        for key in self.transport.keys(_HB):
            raw = self.transport.get(key)
            if raw is None:
                continue
            try:
                b = json.loads(raw)
            except ValueError:
                continue
            out[key[len(_HB):]] = b
        return out

    def alive(self, beats: Optional[Dict[str, dict]] = None) -> Set[str]:
        now = self._clock()
        beats = self.beats() if beats is None else beats
        return {h for h, b in beats.items()
                if now - float(b.get("ts", -1e18)) <= self.heartbeat_timeout}

    # -- membership -----------------------------------------------------
    def bootstrap(self, members: Sequence[str]):
        """Write incarnation 0 with the initial gang (idempotent: a
        pre-existing incarnation wins)."""
        if self.transport.get(_INC) is None:
            self.transport.put(_INC, json.dumps({
                "n": 0, "members": sorted(members),
                "reason": "bootstrap", "by": self.host}))

    def membership(self) -> Tuple[int, Tuple[str, ...]]:
        raw = self.transport.get(_INC)
        if raw is None:
            return 0, (self.host,)
        rec = json.loads(raw)
        return int(rec["n"]), tuple(rec["members"])

    def propose(self, members: Sequence[str], reason: str,
                expect: Optional[int] = None) -> Optional[int]:
        """Publish incarnation ``current+1`` with ``members``.  With
        ``expect``, only when the current incarnation still matches
        (losing a race means someone else reconfigured first — adopt
        theirs instead).  Returns the new incarnation, or None."""
        cur, _ = self.membership()
        if expect is not None and cur != expect:
            return None
        n = cur + 1
        self.transport.put(_INC, json.dumps({
            "n": n, "members": sorted(set(members)), "reason": str(reason),
            "by": self.host}))
        log.warning("elastic: proposed incarnation %d (%s) members=%s",
                    n, reason, sorted(set(members)))
        _record_change("membership_change",
                       f"incarnation={n} reason={reason} "
                       f"members={len(set(members))}",
                       source="resilience.elastic", host=self.host)
        self.ack(n)
        return n

    def ack(self, n: int):
        self.transport.put(f"{_ACK}{int(n)}/{self.host}", "1")

    # -- eviction markers ----------------------------------------------
    def evict(self, host: str, reason: str):
        self.transport.put(_EVICTED + str(host), json.dumps(
            {"reason": str(reason), "by": self.host}))
        _record_change("membership_evict", str(reason),
                       source="resilience.elastic", host=host)

    def readmit(self, host: str):
        self.transport.delete(_EVICTED + str(host))
        _record_change("membership_readmit",
                       source="resilience.elastic", host=host)
