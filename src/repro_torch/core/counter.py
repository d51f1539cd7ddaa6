"""A checkpointable monotone counter.

`itertools.count` is the natural id/sequence generator, but its position
is opaque: you cannot read where a stream is, and you cannot put it back
there after a restore. Every platform id stream (document ids, broker
message ids, subscription order, delayed-delivery order, event-engine
sequence numbers) must survive a checkpoint/restore round trip at the
*exact* same position — the seeded fault plan hashes message ids and the
engine heap ties break on sequence numbers, so a counter that restarts
from zero silently changes the whole event interleaving.

`Counter` is `next()`-compatible with `itertools.count` (the call sites
keep reading `next(self._ids)`) and exposes the position as a plain
``.n`` attribute for `FleetCheckpoint` to read and set.
"""
from __future__ import annotations


class Counter:
    """Drop-in for ``itertools.count(start)`` with a readable/settable
    position: ``next(c)`` returns ``c.n`` and advances it."""

    __slots__ = ("n",)

    def __init__(self, start: int = 0):
        self.n = int(start)

    def __next__(self) -> int:
        v = self.n
        self.n += 1
        return v

    def __iter__(self) -> "Counter":
        return self

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter(n={self.n})"
