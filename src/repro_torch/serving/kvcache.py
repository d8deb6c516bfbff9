"""Session-slot bookkeeping for batched decoding (counterpart of
``src/repro/serving/kvcache.py``): lane binding with LRU eviction, and the
decode state's byte size that the session router charges migrations
with."""

from __future__ import annotations

import time
from typing import Optional

from repro_torch import tree as tree_lib

__all__ = ["LaneTable", "state_bytes"]


def state_bytes(state) -> int:
    """Total decode-state bytes (the migration payload for one full batch):
    every tensor of the state's tree (NamedTuples, lists and tuples
    nested), as the reference sums ``jax.tree.leaves``."""
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(state))


class LaneTable:
    """session_id <-> lane binding with LRU eviction."""

    def __init__(self, num_lanes: int):
        self.num_lanes = num_lanes
        self._lane_of: dict[str, int] = {}
        self._session_of: dict[int, str] = {}
        self._last_used: dict[int, float] = {}

    def lookup(self, session: str) -> Optional[int]:
        lane = self._lane_of.get(session)
        if lane is not None:
            self._last_used[lane] = time.monotonic()
        return lane

    def bind(self, session: str) -> tuple[int, Optional[str]]:
        """Assign a lane, evicting the LRU session if all are bound.
        Returns ``(lane, evicted_session|None)``."""
        if session in self._lane_of:
            return self._lane_of[session], None
        free = set(range(self.num_lanes)) - set(self._session_of)
        evicted = None
        if free:
            lane = min(free)
        else:
            lane = min(self._last_used, key=self._last_used.get)
            evicted = self._session_of.pop(lane)
            del self._lane_of[evicted]
        self._lane_of[session] = lane
        self._session_of[lane] = session
        self._last_used[lane] = time.monotonic()
        return lane, evicted

    def release(self, session: str) -> None:
        lane = self._lane_of.pop(session, None)
        if lane is not None:
            self._session_of.pop(lane, None)
            self._last_used.pop(lane, None)

    @property
    def active(self) -> dict[str, int]:
        return dict(self._lane_of)
