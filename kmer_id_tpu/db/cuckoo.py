"""2-choice bucketized cuckoo layout for O(1)-gather device lookups.

The sorted-array binary search costs ~log2(bucket) gather rounds per query;
each gather round over the whole query batch is a random-access pass over
device memory, so lookup cost is directly proportional to gather rounds.  This layout
gets it down to **two wide row-gathers per query**:

* buckets of 4 slots, each slot a 16-byte row ``[key_hi, key_lo, target,
  probe_idx]``; a bucket is one 64-byte row — a single gather fetches it;
* every key lives in one of two buckets derived from two 32-bit mixes of its
  key words; lookup gathers both candidate buckets and compares 8 slots
  vectorized;
* the row carries the probe's target *and* its index in the canonical sorted
  order, so the hit needs no further gathers and the `seen` bitmap stays
  indexed by sorted position (ucount/sharding unchanged).

Host build: vectorized greedy placement rounds (one insertion per bucket per
round) + vectorized random-walk eviction for stragglers; retries with fresh
salts, growing the table if placement fails.  Empty slots carry key_hi =
0xFFFFFFFF, unreachable by real keys (hi < 2^28).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SLOTS = 4
EMPTY_HI = np.uint32(0xFFFFFFFF)


def _mix32(a: np.ndarray, b: np.ndarray, s1: int, s2: int) -> np.ndarray:
    x = a ^ (b * np.uint32(s1))
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x2C1B3C6D)
    x ^= x >> np.uint32(12)
    x *= np.uint32(s2)
    x ^= x >> np.uint32(16)
    return x


@dataclass
class CuckooTable:
    table: np.ndarray  # uint32 [nb, 4*SLOTS]
    nb: int
    s1: int
    s2: int


def build_cuckoo(
    hi: np.ndarray,
    lo: np.ndarray,
    target: np.ndarray,
    load: float = 0.75,
    max_evict_rounds: int = 6000,
) -> CuckooTable:
    hi = np.ascontiguousarray(hi, dtype=np.uint32)
    lo = np.ascontiguousarray(lo, dtype=np.uint32)
    n = len(hi)
    nb = 1 << max(4, int(np.ceil(np.log2(max(n, 1) / (SLOTS * load)))))
    while True:
        for attempt in range(6):
            s1 = 0x9E3779B1 + attempt * 7919
            s2 = 0x85EBCA6B + attempt * 104729
            slot_of = _place(hi, lo, nb, s1, s2, max_evict_rounds)
            if slot_of is not None:
                table = np.zeros((nb * SLOTS, 4), dtype=np.uint32)
                table[:, 0] = EMPTY_HI
                table[slot_of, 0] = hi
                table[slot_of, 1] = lo
                table[slot_of, 2] = target.astype(np.uint32)
                table[slot_of, 3] = np.arange(n, dtype=np.uint32)
                return CuckooTable(table.reshape(nb, 4 * SLOTS), nb, s1, s2)
        nb *= 2  # placement failed at this density: grow


def _place(hi, lo, nb, s1, s2, max_evict_rounds):
    n = len(hi)
    mask = np.uint32(nb - 1)
    h1 = (_mix32(hi, lo, s1, s2) & mask).astype(np.int64)
    h2 = (_mix32(lo, hi, s1, s2) & mask).astype(np.int64)
    occ = np.zeros(nb, dtype=np.int64)
    slot_of = np.full(n, -1, dtype=np.int64)
    unplaced = np.arange(n)
    # greedy alternating rounds, no eviction
    for rnd in range(30):
        if len(unplaced) == 0:
            return slot_of
        hh = h1 if rnd % 2 == 0 else h2
        b = hh[unplaced]
        order = np.argsort(b, kind="stable")
        bs = b[order]
        first = np.concatenate([[True], bs[1:] != bs[:-1]])
        starts = np.where(first, np.arange(len(bs)), 0)
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(len(bs)) - starts
        fits = rank < (SLOTS - occ[bs])
        placed = order[fits]
        slot_of[unplaced[placed]] = bs[fits] * SLOTS + occ[bs[fits]] + rank[fits]
        np.add.at(occ, bs[fits], 1)
        unplaced = unplaced[order[~fits]]
    # random-walk eviction for the stragglers: one insert per bucket per round
    slot_key = np.full(nb * SLOTS, -1, dtype=np.int64)
    pm = slot_of >= 0
    slot_key[slot_of[pm]] = np.nonzero(pm)[0]
    rng = np.random.default_rng(s1)
    for _ in range(max_evict_rounds):
        if len(unplaced) == 0:
            return slot_of
        side = rng.integers(0, 2, size=len(unplaced))
        b = np.where(side == 0, h1[unplaced], h2[unplaced])
        _, first = np.unique(b, return_index=True)
        movers = unplaced[first]
        vb = b[first]
        vslot = vb * SLOTS + rng.integers(0, SLOTS, size=len(vb))
        victims = slot_key[vslot]
        slot_key[vslot] = movers
        slot_of[movers] = vslot
        rest = np.ones(len(unplaced), bool)
        rest[first] = False
        unplaced = np.concatenate([unplaced[rest], victims[victims >= 0]])
    return None
