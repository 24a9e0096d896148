"""OnlinePacker — incremental bin maintenance for arbiter placement.

The arbiter used to re-run first-fit-decreasing from scratch every
``placement()`` call, which has two costs at production scale: the packing
is O(groups x bins) per tick even when nothing changed, and — worse — FFD
is *unstable*: a one-device demand change can reshuffle every group into a
different bin, which at the runner layer would mean pointless pilot/state
movement. The online bin-packing formulation (Stein et al.,
arXiv:2001.10865) amends the existing packing instead:

* an unchanged group stays exactly where it is (zero relocations is the
  steady state);
* a resized group first tries to grow/shrink *in place*; only when its bin
  overflows is it relocated, first-fit, to another bin (counted in
  :attr:`relocations` — the instability metric the per-tick-FFD design
  couldn't even report);
* a new group is placed first-fit into the existing bins, else opens a
  fresh bin;
* a departed group is removed, and emptied bins are dropped.

Bin *identity* is positional and sticky: at the runner layer a bin maps to
a host/pilot, so "group stayed in bin 2" is exactly "no state moved".
"""
from __future__ import annotations


class OnlinePacker:
    """Maintains ``group name -> bin`` across repeated demand revisions.

    Not thread-safe; the arbiter calls it under its own lock.
    """

    def __init__(self, capacity: float):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = float(capacity)
        #: bin index -> {group: size}; bins keep their index across calls
        self._bins: list[dict[str, float]] = []
        #: cumulative groups moved to a different bin by a resize (new
        #: placements and capacity resets don't count — only churn does)
        self.relocations = 0

    # -- introspection -------------------------------------------------------

    @property
    def bins(self) -> list[dict[str, float]]:
        return [dict(b) for b in self._bins]

    def bin_of(self, group: str) -> int | None:
        for i, b in enumerate(self._bins):
            if group in b:
                return i
        return None

    def _load(self, b: dict[str, float]) -> float:
        return sum(b.values())

    def _first_fit(self, size: float) -> int:
        """Index of the first bin with room, appending a new one if none
        (an oversized group still gets a bin of its own, like FFD)."""
        for i, b in enumerate(self._bins):
            if self._load(b) + size <= self.capacity:
                return i
        self._bins.append({})
        return len(self._bins) - 1

    # -- the amendment pass --------------------------------------------------

    def repack(self, demands: dict[str, float]) -> list[list[str]]:
        """Amend the packing to ``demands`` (group -> size; zero/negative
        sizes mean the group holds nothing and is unplaced). Returns the
        bins as ordered group-name lists, empty bins elided."""
        live = {g: float(s) for g, s in demands.items() if s > 0}

        # departures (and zero-size groups) leave their bins
        for b in self._bins:
            for g in [g for g in b if g not in live]:
                del b[g]

        # resizes: in place when the bin still fits, relocate otherwise.
        # Shrinks always fit; process growths largest-first so a bin's
        # survivors are judged against the post-shrink load.
        for g in sorted(live, key=lambda g: -live[g]):
            i = self.bin_of(g)
            if i is None:
                continue  # new group, placed below
            b = self._bins[i]
            if b[g] == live[g]:
                continue
            grew = live[g] > b[g]
            b[g] = live[g]
            if grew and self._load(b) > self.capacity and len(b) > 1:
                del b[g]
                self._bins[self._first_fit(live[g])][g] = live[g]
                self.relocations += 1

        # arrivals: first-fit, largest first (the FFD ordering, but only
        # over the new groups — incumbents don't move for an arrival)
        placed = {g for b in self._bins for g in b}
        for g in sorted(live.keys() - placed, key=lambda g: (-live[g], g)):
            self._bins[self._first_fit(live[g])][g] = live[g]

        self._bins = [b for b in self._bins if b]
        return [list(b) for b in self._bins]

    def reset(self, capacity: float | None = None) -> None:
        """Forget the packing (e.g. the bin size changed — positions keyed
        to the old capacity are meaningless)."""
        if capacity is not None:
            if capacity <= 0:
                raise ValueError("capacity must be positive")
            self.capacity = float(capacity)
        self._bins = []
