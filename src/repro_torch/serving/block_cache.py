"""Block-paged per-request slot cache — the continuous tier's host-side state.

The continuous-batching backend keeps one persistent decode batch of
``n_slots`` rows.  Each slot's KV state lives in *pages* of a shared
physical pool; this module owns the host-side bookkeeping:

* the free-page pool and the per-slot page tables (page 0 is reserved as
  the trash page inactive rows write into — it is never allocated);
* the slot lifecycle ``FREE → PREFILLING → DECODING → RECYCLED``;
* conservation accounting: every slot freed is attributed to exactly one
  release reason (``resolved`` / ``hedge_win`` / ``cancel``), so
  ``freed_total == sum(freed_by_reason.values())`` and, at quiescence,
  every page is back in the free pool.  ``tests/test_torch_continuous.py`` pins
  both invariants.

Pages are reserved *exactly* at graft time — ``ceil((prompt_len + n_steps)
/ page_size)`` pages per request — so a slot released early (a hedge win,
a cancel) returns its pages immediately and the next join reuses them; the
device-side pool never needs to grow or compact.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List

import numpy as np

__all__ = ["SlotState", "Slot", "BlockPagedSlotCache", "NoFreeSlot"]


class NoFreeSlot(Exception):
    """Raised when a join is requested and every slot is occupied."""


class SlotState(enum.Enum):
    FREE = "free"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    RECYCLED = "recycled"  # released; pages returned, awaiting next graft


@dataclasses.dataclass
class Slot:
    index: int
    state: SlotState = SlotState.FREE
    pages: List[int] = dataclasses.field(default_factory=list)
    prompt_len: int = 0
    n_steps: int = 0


class BlockPagedSlotCache:
    """Host-side page-pool + slot-table manager for the continuous batch.

    Device arrays (the KV page pools themselves) are owned by the backend;
    this class only decides *which* pages each slot uses and exposes the
    ``(n_slots, pages_per_slot)`` int32 page-table array the fixed-shape
    decode executable consumes.  Unreserved table entries point at the
    trash page (0), which the attention mask guarantees is never read.
    """

    TRASH_PAGE = 0

    def __init__(self, n_slots: int, n_pages: int, page_size: int,
                 pages_per_slot: int):
        if n_pages < 2:
            raise ValueError("need at least the trash page plus one real page")
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        # Page 0 is the trash page: reserved forever, never in the free pool.
        self._free_pages: List[int] = list(range(n_pages - 1, 0, -1))
        self.slots = [Slot(i) for i in range(n_slots)]
        # Conservation counters (the regression-pinned invariant).
        self.grafted_total = 0
        self.freed_total = 0
        self.freed_by_reason: Dict[str, int] = {
            "resolved": 0, "hedge_win": 0, "cancel": 0,
        }
        # Optional metrics hookup (set by the continuous backend); None
        # keeps the ledger metric-free.
        self._obs = None
        self._obs_labels: Dict[str, str] = {}

    def attach_observability(self, obs, **labels) -> None:
        """Mirror the conservation ledger into counters/gauges."""
        self._obs = obs
        self._obs_labels = labels

    def _note_capacity(self) -> None:
        self._obs.gauge(
            "slot_cache_free_pages", **self._obs_labels
        ).set(self.n_free_pages)
        self._obs.gauge(
            "slot_cache_free_slots", **self._obs_labels
        ).set(len(self.free_slots))

    # -- queries --------------------------------------------------------------
    @property
    def free_slots(self) -> List[int]:
        return [
            s.index
            for s in self.slots
            if s.state in (SlotState.FREE, SlotState.RECYCLED)
        ]

    @property
    def n_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def active_slots(self) -> List[int]:
        return [s.index for s in self.slots if s.state is SlotState.DECODING]

    def pages_needed(self, prompt_len: int, n_steps: int) -> int:
        return -(-(prompt_len + n_steps) // self.page_size)

    def can_join(self, prompt_len: int, n_steps: int) -> bool:
        return (
            bool(self.free_slots)
            and self.pages_needed(prompt_len, n_steps) <= self.n_free_pages
        )

    # -- lifecycle ------------------------------------------------------------
    def begin_prefill(self, prompt_len: int, n_steps: int) -> Slot:
        """FREE/RECYCLED → PREFILLING: claim a slot and reserve its pages.

        The reservation is exact — ``ceil((prompt_len + n_steps) /
        page_size)`` pages — so the pool can admit as many concurrent
        requests as genuinely fit, not a worst-case bound.
        """
        need = self.pages_needed(prompt_len, n_steps)
        if need > self.pages_per_slot:
            raise ValueError(
                f"request needs {need} pages > pages_per_slot "
                f"({self.pages_per_slot}); raise ServingGeometry.max_steps "
                "or prompt_width"
            )
        free = self.free_slots
        if not free:
            raise NoFreeSlot("all decode slots occupied")
        if need > self.n_free_pages:
            raise NoFreeSlot(
                f"page pool exhausted ({need} needed, {self.n_free_pages} free)"
            )
        slot = self.slots[free[0]]
        slot.state = SlotState.PREFILLING
        slot.pages = [self._free_pages.pop() for _ in range(need)]
        slot.prompt_len = prompt_len
        slot.n_steps = n_steps
        return slot

    def commit_graft(self, slot_index: int) -> None:
        """PREFILLING → DECODING: the KV state landed in the slot's pages."""
        slot = self.slots[slot_index]
        if slot.state is not SlotState.PREFILLING:
            raise ValueError(f"slot {slot_index} not prefilling: {slot.state}")
        slot.state = SlotState.DECODING
        self.grafted_total += 1
        if self._obs is not None:
            self._obs.counter(
                "slot_cache_grafted_total", **self._obs_labels
            ).inc()
            self._note_capacity()

    def release(self, slot_index: int, reason: str) -> None:
        """PREFILLING/DECODING → RECYCLED: return the slot's pages.

        ``reason`` must be one of ``resolved`` / ``hedge_win`` / ``cancel``
        — the conservation ledger every release is attributed to.
        """
        if reason not in self.freed_by_reason:
            raise ValueError(
                f"unknown release reason {reason!r}; "
                f"expected one of {sorted(self.freed_by_reason)}"
            )
        slot = self.slots[slot_index]
        if slot.state not in (SlotState.PREFILLING, SlotState.DECODING):
            raise ValueError(
                f"slot {slot_index} not releasable from {slot.state}"
            )
        self._free_pages.extend(reversed(slot.pages))
        slot.pages = []
        slot.prompt_len = 0
        slot.n_steps = 0
        slot.state = SlotState.RECYCLED
        self.freed_total += 1
        self.freed_by_reason[reason] += 1
        if self._obs is not None:
            self._obs.counter(
                "slot_cache_freed_total", reason=reason, **self._obs_labels
            ).inc()
            self._note_capacity()

    # -- device-facing views ---------------------------------------------------
    def page_table(self, slot_index: int) -> np.ndarray:
        """(pages_per_slot,) int32 table, trash-padded past the reservation."""
        table = np.full(self.pages_per_slot, self.TRASH_PAGE, dtype=np.int32)
        pages = self.slots[slot_index].pages
        table[: len(pages)] = pages
        return table

    def page_tables(self) -> np.ndarray:
        """(n_slots, pages_per_slot) int32 — the decode executable's view."""
        return np.stack([self.page_table(i) for i in range(self.n_slots)])

    # -- invariants ------------------------------------------------------------
    def check_conservation(self) -> None:
        """Assert the ledger balances (used by tests and debug paths)."""
        by_reason = sum(self.freed_by_reason.values())
        if self.freed_total != by_reason:
            raise AssertionError(
                f"freed_total={self.freed_total} != sum(reasons)={by_reason}"
            )
        reserved = sum(len(s.pages) for s in self.slots)
        if reserved + self.n_free_pages != self.n_pages - 1:
            raise AssertionError(
                f"page leak: {reserved} reserved + {self.n_free_pages} free "
                f"!= {self.n_pages - 1} allocatable"
            )

    def stats(self) -> Dict[str, int]:
        return {
            "grafted": self.grafted_total,
            "freed": self.freed_total,
            **{f"freed_{k}": v for k, v in self.freed_by_reason.items()},
            "free_pages": self.n_free_pages,
            "free_slots": len(self.free_slots),
        }
