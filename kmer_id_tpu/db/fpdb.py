"""Fingerprint probe DB: the transfer-light two-level device lookup layout.

Motivation: a random row gather costs about one memory transaction per row
whatever the row's width, so the layout minimizes the number of gathers per
window into large tables.  The reference's per-kmer hash probe
(``newkmer_10nx.cpp:204-233``) therefore becomes:

1. **L1 fingerprint stage** (every window): ONE 16-byte row-gather into
   ``fptab`` — a single-choice bucket table of 8 x u16 fingerprints, sized
   for load <= 0.45 so almost every key fits its one bucket.  A 2-choice
   cuckoo here would cost two big-table gathers per window; one is worth
   the extra slots (16 B/slot).
2. **L2 fingerprint stage** (every window, cheap): two row-gathers into
   ``fptab2`` — a small 2-choice cuckoo holding the few % of keys whose L1
   bucket ran out of slots (or fingerprint-collided there).  fptab2 stays
   small (a few MB) by construction.
3. **Verify stage** (candidates only, compacted to <= max_hits per read):
   one 12-byte row-gather into ``rec`` fetches the slot's full 60-bit key
   (exactness: fingerprints only pre-filter; the key compare decides) plus a
   taxonomy payload — the ``tin`` DFS entry label and ``depth`` of the
   probe's target (core/taxonomy.py); one gather of the tiny
   tin-indexed :func:`build_tinfo` map turns tin into (node, tout), so the
   per-read MSCA consistency fold needs **zero** additional big-table
   gathers.

Build-time invariants: no bucket (either level) holds two equal
fingerprints, so a bucket yields at most one candidate slot and a present
key is found in exactly one of its three probe buckets.  False fingerprint
matches (~24 * 2^-16 per miss window) cost one wasted verify row and are
rejected exactly.  Misses never touch ``rec``.

Slot id = bucket * 8 + slot (L2 offset by ``nb1 * 8``) is the engine's
per-probe identity: the host keeps ``slot_target`` / ``slot_idx``
(sorted-order index) maps for final-call resolution, the per-sample
unique-k-mer ``seen`` set, and interop with the sorted-array layout used by
the sharded/verify paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SLOTS = 8
EMPTY_HI = np.uint32(0xFFFFFFFF)  # real key hi < 2^28
# rec row layout (12 B): (key_hi, key_lo, tin | depth << 24).  The probe's
# target node and its subtree-exit label ride OUTSIDE the big table, in the
# tiny tin-indexed ``tinfo`` map (engine/fpclassify.FpClassifier builds it
# from the taxonomy: tin is a unique DFS entry time, so tin <-> node is a
# bijection).  Keeping node/tout out of rec keeps rec at 12 B/slot and the
# device holds no [nslots] slot_target array; the (node, tout) lookup is a
# gather of the tiny tinfo map by tin.
# Block-Bloom pre-filter sizing.  The win is STRUCTURAL: one bloom row-gather
# per window replaces three L1/L2 row-gathers plus a full-width candidate
# compaction — only windows that pass ever touch the probe tables.  Block
# count is sized for 8 keys/block (~0.25% false-pass at k=4, ~2.4% at 16
# keys/block) and capped at 2^24 blocks = 268 MB.  Past the cap the realized
# keys/block rises back toward 16+ (the real bact10 scale, ~1e8 probes,
# lands at ~6/block, under it).  The low false-pass rate is what lets the
# engine compact filter-passing windows to the narrow BLOOM_K budget — the
# whole candidate/verify pipeline scales with BLOOM_K, not window count.
# Whether this sizing is the right one for a filter larger than the H100's
# 50 MB L2 (67 MB at 33M keys) is not measured on the H100.  Sharded
# meshes build per-shard filters (parallel/fpsharded._shard_blooms): each
# shard's filter holds only its own keys.
BLOOM_KEYS_PER_BLOCK = 8
BLOOM_MAX_BLOCKS = 1 << 24  # 2^24 blocks * 16 B = 268 MB
_BLOOM_MAX_KEYS_PER_BLOCK = 32  # beyond this the filter passes too much to help
# L1 bucket-count target: nb1 is snapped to a power of two, so the realized
# load lands in (0.28, 0.56] after the halving rule below.  At load ~0.5 the
# single-choice overflow fraction is ~2-3% (Poisson tail past 8 slots +
# per-bucket fingerprint duplicates) — the L2 overflow cuckoo absorbs it and
# stays a few MB up to ~1e8-key DBs.  Running L1 this full halves
# fptab/rec/seen bytes per key against a 0.35 target.
MAX_LOAD_L1 = 0.45
MIN_LOAD_L1 = 0.28  # below this, halve nb1 once (pow2 snap waste cap)
MAX_LOAD_L2 = 0.5


def _mix32(a: np.ndarray, b: np.ndarray, s1: int, s2: int) -> np.ndarray:
    x = a ^ (b * np.uint32(s1))
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x2C1B3C6D)
    x ^= x >> np.uint32(12)
    x *= np.uint32(s2)
    x ^= x >> np.uint32(16)
    return x


def fp_hashes(hi: np.ndarray, lo: np.ndarray, nb: int, s1: int, s2: int, s3: int):
    """(bucket1, bucket2, fingerprint) for key words — numpy mirror of the
    device hash in ops/lookup.fp_hashes_jnp (kept bit-identical by tests).
    L1 uses bucket1 only; L2 uses both with its own salts (fingerprint is
    shared across levels: the device computes it once per window)."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    mask = np.uint32(nb - 1)
    b1 = _mix32(hi, lo, s1, s2) & mask
    b2 = _mix32(lo, hi, s2, s1) & mask
    m = _mix32(hi ^ np.uint32(0x6A09E667), lo, s3, s1)
    fp = ((m ^ (m >> np.uint32(16))) & np.uint32(0xFFFF)).astype(np.uint16)
    fp = np.where(fp == 0, np.uint16(1), fp)  # 0 = empty slot sentinel
    return b1.astype(np.int64), b2.astype(np.int64), fp


BLOOM_BITS = 4  # bits set per key, all drawn from ONE mixed word (no extra
# gathers — the whole 128-bit block rides in the single row fetch).  At the
# 8-keys/block sizing, k=4 gives ~0.25% false-pass (~2.4% at 16/block).


def bloom_hashes(hi: np.ndarray, lo: np.ndarray, nblk: int, s4: int, s5: int):
    """(block, [bit1..bitK]) for the 128-bit-block Bloom filter — numpy
    mirror of ops/lookup.bloom_hashes_jnp (kept bit-identical by tests).
    Reuses the L2 salts with distinct xor constants, so no new salt state is
    needed."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    blk = (_mix32(hi ^ np.uint32(0x243F6A88), lo, s4, s5) & np.uint32(nblk - 1)).astype(np.int64)
    m = _mix32(lo ^ np.uint32(0xB7E15162), hi, s5, s4)
    bits = [
        ((m >> np.uint32(7 * j)) & np.uint32(127)).astype(np.int64)
        for j in range(BLOOM_BITS)
    ]
    return blk, bits


def bloom_blocks_for(n_keys: int) -> int | None:
    """Block count for an n-key filter, or None when even the largest filter
    would hold more than _BLOOM_MAX_KEYS_PER_BLOCK keys per block (it would
    then pass too many windows to pay for itself)."""
    if n_keys <= 0:
        return None
    nblk = 1 << max(10, int(np.ceil(np.log2(n_keys / BLOOM_KEYS_PER_BLOCK))))
    if nblk > BLOOM_MAX_BLOCKS:
        nblk = BLOOM_MAX_BLOCKS
        if n_keys / nblk > _BLOOM_MAX_KEYS_PER_BLOCK:
            return None
    return nblk


def build_bloom(hi: np.ndarray, lo: np.ndarray, s4: int, s5: int,
                nblk: int | None = None) -> np.ndarray | None:
    """uint32 [nblk, 4] block-Bloom table with all BLOOM_BITS bits of every
    key set (no false negatives by construction; tests assert).  Pass
    ``nblk`` to force a block count (the sharded engine sizes every shard's
    filter identically so the mesh kernel keeps one static shape)."""
    if nblk is None:
        nblk = bloom_blocks_for(len(hi))
    if nblk is None:
        return None
    blk, bits = bloom_hashes(hi, lo, nblk, s4, s5)
    words = np.zeros(nblk * 4, dtype=np.uint32)
    for bit in bits:
        np.bitwise_or.at(
            words, blk * 4 + (bit >> 5), np.uint32(1) << (bit & 31).astype(np.uint32)
        )
    return words.reshape(nblk, 4)


def build_tinfo(taxonomy) -> np.ndarray:
    """int32 [num_nodes, 2] (node, tout) indexed by the node's DFS entry
    time ``tin`` (a bijection — every node has a unique tin in [0, n)).

    The verify stage reads (tin, depth) straight from a rec row; ONE gather
    of this small table resolves the probe's target node id and its
    subtree-exit label for the consistency test, so no [nslots] slot_target
    array lives on the device."""
    n = taxonomy.num_nodes
    tinfo = np.zeros((n, 2), dtype=np.int32)
    tinfo[taxonomy.tin] = np.stack(
        [np.arange(n, dtype=np.int32), taxonomy.tout.astype(np.int32)], axis=1
    )
    return tinfo


def _pack_fptab(slot_fp: np.ndarray, nb: int) -> np.ndarray:
    """u16 fp per slot -> [nb, 4] u32 rows; slot s of bucket b lives at word
    (s & 3), u16 half (s >> 2), so the device's match index (half*4 + word)
    equals s and cand = bucket*8 + s = slot id."""
    t = slot_fp.reshape(nb, 2, 4)
    return t[:, 0, :].astype(np.uint32) | (
        t[:, 1, :].astype(np.uint32) << np.uint32(16)
    )


@dataclass
class FpDB:
    """Device-ready fingerprint layout + host-side slot maps."""

    fptab: np.ndarray  # uint32 [nb1, 4] — L1: 8 u16 fps per bucket
    fptab2: np.ndarray  # uint32 [nb2, 4] — L2 overflow cuckoo
    rec: np.ndarray  # uint32 [(nb1+nb2)*8, 3] — (key_hi, key_lo, tin|depth<<24)
    nb: int  # L1 buckets
    nb2: int  # L2 buckets
    s1: int  # L1 bucket salt
    s2: int
    s3: int  # fingerprint salt (shared by both levels)
    s4: int  # L2 bucket salts
    s5: int
    slot_target: np.ndarray  # int32 [(nb1+nb2)*8]; 0 for empty slots
    slot_idx: np.ndarray  # int32 [(nb1+nb2)*8]; index into the sorted packed arrays, -1 empty
    bloom: np.ndarray | None = None  # uint32 [nblk, 4] block-Bloom pre-filter (None when
    # the DB exceeds the filter budget; see bloom_blocks_for)

    @property
    def n_slots(self) -> int:
        return (self.nb + self.nb2) * SLOTS

    def device_arrays(self) -> dict:
        return {"fptab": self.fptab, "fptab2": self.fptab2, "rec": self.rec}


def build_fpdb(packed, taxonomy, load: float = MAX_LOAD_L1) -> FpDB:
    """Build from a PackedDB (sorted unique keys) + Taxonomy.

    Probes with target <= 0 are excluded: in the reference a cell with value 0
    terminates probing, so such entries always read back as misses
    (``newkmer_10nx.cpp:223-233``) — dropping them is behavior-preserving.
    """
    live = np.nonzero(packed.target > 0)[0].astype(np.int64)
    hi = np.ascontiguousarray(packed.hi[live], dtype=np.uint32)
    lo = np.ascontiguousarray(packed.lo[live], dtype=np.uint32)
    target = packed.target[live].astype(np.int64)
    n = len(hi)
    nt = taxonomy.num_nodes
    if nt > (1 << 24) or taxonomy.max_depth > 254:
        raise ValueError("taxonomy too large for fp payload packing")
    nb1 = 1 << max(4, int(np.ceil(np.log2(max(n, 1) / (SLOTS * load)))))
    # power-of-two snapping can leave realized load as low as load/2,
    # inflating rec bytes/key just past a pow2 boundary; when the waste is
    # egregious (< MIN_LOAD_L1), halve nb1 once and let the L2 overflow
    # cuckoo absorb the larger spill (a few % of keys)
    if nb1 > 16 and n / (nb1 * SLOTS) < MIN_LOAD_L1:
        nb1 >>= 1
    for attempt in range(6):
        s1 = 0x9E3779B1 + attempt * 7919
        s2 = 0x85EBCA6B + attempt * 104729
        s3 = 0xC2B2AE35 + attempt * 65537
        s4 = 0x27D4EB2F + attempt * 31337
        s5 = 0x165667B1 + attempt * 49999

        b1, _, fp16 = fp_hashes(hi, lo, nb1, s1, s2, s3)
        fp = fp16.astype(np.int64)
        # L1 single-choice: within each bucket keep up to 8 keys with
        # distinct fingerprints (first by (bucket, fp) sort order)
        order = np.argsort(b1 * 65536 + fp, kind="stable")
        bs = b1[order]
        fs = fp[order]
        first_bf = np.ones(len(order), dtype=bool)
        first_bf[1:] = (bs[1:] != bs[:-1]) | (fs[1:] != fs[:-1])
        cand = order[first_bf]
        bsel = b1[cand]
        fb = np.ones(len(cand), dtype=bool)
        fb[1:] = bsel[1:] != bsel[:-1]
        starts = np.where(fb, np.arange(len(cand)), 0)
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(len(cand)) - starts
        fits = rank < SLOTS
        placed = cand[fits]
        slot_of1 = bsel[fits] * SLOTS + rank[fits]
        inl1 = np.zeros(n, dtype=bool)
        inl1[placed] = True
        over = np.nonzero(~inl1)[0]

        # L2: 2-choice cuckoo over the overflow, same fingerprints
        nb2 = 1 << max(
            10, int(np.ceil(np.log2(max(len(over), 1) / (SLOTS * MAX_LOAD_L2))))
        )
        slot_of2 = None
        while nb2 <= max(nb1, 1 << 14):
            slot_of2 = _place(
                hi[over], lo[over], nb2, s4, s5, s3, fp_in=fp[over]
            )
            if slot_of2 is not None:
                break
            nb2 *= 2
        if slot_of2 is None:
            continue  # re-salt everything

        slot_fp1 = np.zeros(nb1 * SLOTS, dtype=np.uint16)
        slot_fp1[slot_of1] = fp16[placed]
        slot_fp2 = np.zeros(nb2 * SLOTS, dtype=np.uint16)
        slot_fp2[slot_of2] = fp16[over]

        slot_of = np.empty(n, dtype=np.int64)
        slot_of[placed] = slot_of1
        slot_of[over] = nb1 * SLOTS + slot_of2

        nslots = (nb1 + nb2) * SLOTS
        rec = np.zeros((nslots, 3), dtype=np.uint32)
        rec[:, 0] = EMPTY_HI
        tgt_clip = np.clip(target, 0, nt - 1)
        rec[slot_of, 0] = hi
        rec[slot_of, 1] = lo
        rec[slot_of, 2] = taxonomy.tin[tgt_clip].astype(np.uint32) | (
            taxonomy.depth[tgt_clip].astype(np.uint32) << np.uint32(24)
        )
        slot_target = np.zeros(nslots, dtype=np.int32)
        slot_target[slot_of] = target
        slot_idx = np.full(nslots, -1, dtype=np.int32)
        slot_idx[slot_of] = live
        return FpDB(
            fptab=_pack_fptab(slot_fp1, nb1),
            fptab2=_pack_fptab(slot_fp2, nb2),
            rec=rec, nb=nb1, nb2=nb2,
            s1=s1, s2=s2, s3=s3, s4=s4, s5=s5,
            slot_target=slot_target, slot_idx=slot_idx,
            bloom=build_bloom(hi, lo, s4, s5),
        )
    raise RuntimeError("fpdb build failed to converge after 6 salt attempts")


def _place(hi, lo, nb, s1, s2, s3, fp_in=None, max_evict_rounds: int = 3000):
    """Assign each key a slot honoring capacity + per-bucket fp uniqueness.

    Two fully-vectorized phases (build time on multi-10M-key DBs is
    sort-bound, not Python-bound):

    1. *Greedy rounds*: every unplaced key tries the emptier of its two
       buckets; placement is capacity-ranked per bucket and deferred on
       fingerprint conflicts.
    2. *Parallel random-walk eviction*: all stragglers hop at once each
       round — pick a random side, displace a same-fingerprint resident if
       present (which simultaneously restores fp uniqueness), else take an
       empty slot, else kick a random resident (who rejoins the walk).
       Same-slot / same-(bucket, fp) write races are resolved by keeping one
       winner per round; losers retry next round.

    ``fp_in``: fingerprint per key (int64, 0 reserved); defaults to the
    fp_hashes fingerprint of (nb, s1, s2, s3) — the two-level build passes
    the L1 fingerprints so the device can compute one fp per window.
    """
    n = len(hi)
    b1, b2, fp = fp_hashes(hi, lo, nb, s1, s2, s3)
    fp = fp.astype(np.int64) if fp_in is None else np.asarray(fp_in, dtype=np.int64)
    occ = np.zeros(nb, dtype=np.int64)
    slot_fp = np.zeros(nb * SLOTS, dtype=np.int64)  # 0 = empty
    slot_key = np.full(nb * SLOTS, -1, dtype=np.int64)
    slot_of = np.full(n, -1, dtype=np.int64)

    def bucket_has_fp(b, f):
        rows = slot_fp.reshape(nb, SLOTS)[b]
        return (rows == f[:, None]).any(axis=1)

    unplaced = np.arange(n)
    for rnd in range(30):
        if len(unplaced) == 0:
            return slot_of
        f1 = occ[b1[unplaced]]
        f2 = occ[b2[unplaced]]
        bb = np.where(f2 < f1, b2[unplaced], b1[unplaced])
        ff = fp[unplaced]
        # defer same-round duplicates of (bucket, fp) and existing-fp conflicts
        key = bb * 65536 + ff
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.concatenate([[True], ks[1:] != ks[:-1]])
        cand = order[first]
        cand = cand[~bucket_has_fp(bb[cand], ff[cand])]
        # capacity-limited placement (rank within bucket this round)
        bsel = bb[cand]
        o2 = np.argsort(bsel, kind="stable")
        bs = bsel[o2]
        fb = np.concatenate([[True], bs[1:] != bs[:-1]])
        starts = np.where(fb, np.arange(len(bs)), 0)
        np.maximum.accumulate(starts, out=starts)
        rank = np.arange(len(bs)) - starts
        fits = rank < (SLOTS - occ[bs])
        placed_local = cand[o2[fits]]
        slots = bs[fits] * SLOTS + occ[bs[fits]] + rank[fits]
        gidx = unplaced[placed_local]
        slot_of[gidx] = slots
        slot_fp[slots] = fp[gidx]
        slot_key[slots] = gidx
        np.add.at(occ, bs[fits], 1)
        mask = np.ones(len(unplaced), bool)
        mask[placed_local] = False
        unplaced = unplaced[mask]
        if len(unplaced) and rnd > 4 and len(placed_local) == 0:
            break  # greedy fixed point; hand off to eviction

    rng = np.random.default_rng(s1 & 0x7FFFFFFF)
    pend = unplaced
    rows2d = slot_fp.reshape(nb, SLOTS)
    for _ in range(max_evict_rounds):
        u = len(pend)
        if u == 0:
            return slot_of
        side = rng.integers(0, 2, size=u)
        b = np.where(side == 0, b1[pend], b2[pend])
        rows = rows2d[b]  # [U, 8] fingerprints currently in the bucket
        ff = fp[pend]
        conf = rows == ff[:, None]
        has_conf = conf.any(axis=1)
        empt = rows == 0
        has_empt = empt.any(axis=1)
        s = np.where(
            has_conf,
            conf.argmax(axis=1),
            np.where(has_empt, empt.argmax(axis=1), rng.integers(0, SLOTS, size=u)),
        )
        pos = b * SLOTS + s
        # one winner per slot AND per (bucket, fp) pair this round
        k1 = np.unique(pos, return_index=True)[1]
        k2 = np.unique(b * 65536 + ff, return_index=True)[1]
        win = np.intersect1d(k1, k2, assume_unique=True)
        wk = pend[win]
        wpos = pos[win]
        victim = slot_key[wpos]
        slot_fp[wpos] = fp[wk]
        slot_key[wpos] = wk
        slot_of[wk] = wpos
        evicted = victim[victim >= 0]
        slot_of[evicted] = -1
        lose = np.ones(u, dtype=bool)
        lose[win] = False
        pend = np.concatenate([pend[lose], evicted])
    return None  # no convergence: caller re-salts / doubles nb


def save_fpdb(db: FpDB, out_dir) -> None:
    """Persist alongside the packed artifact (same load-once philosophy as
    db/probes.save_packed: text parse + table build happen one time)."""
    import json
    import os

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "fptab.npy"), db.fptab)
    np.save(os.path.join(out_dir, "fptab2.npy"), db.fptab2)
    np.save(os.path.join(out_dir, "rec.npy"), db.rec)
    np.save(os.path.join(out_dir, "slot_target.npy"), db.slot_target)
    np.save(os.path.join(out_dir, "slot_idx.npy"), db.slot_idx)
    if db.bloom is not None:
        np.save(os.path.join(out_dir, "bloom_b8.npy"), db.bloom)
    with open(os.path.join(out_dir, "fp_manifest.json"), "w") as f:
        json.dump(
            {
                "version": 3, "nb": db.nb, "nb2": db.nb2,
                "s1": db.s1, "s2": db.s2, "s3": db.s3,
                "s4": db.s4, "s5": db.s5,
            },
            f,
        )


def load_fpdb(in_dir, mmap: bool = True) -> FpDB | None:
    import json
    import os

    mpath = os.path.join(in_dir, "fp_manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        m = json.load(f)
    if m.get("version") != 3:
        return None  # stale pre-v3 cache (4-word rec rows): rebuild
    mode = "r" if mmap else None

    def arr(name):
        return np.load(os.path.join(in_dir, f"{name}.npy"), mmap_mode=mode)

    bpath = os.path.join(in_dir, "bloom_b8.npy")  # k=4, 8-keys/block scheme;
    # older bloom.npy / bloom4.npy files are ignored and the filter re-derived
    rec = arr("rec")
    bloom = None
    if os.path.exists(bpath):
        try:
            bloom = np.load(bpath, mmap_mode=mode)
        except Exception:
            bloom = None  # torn/corrupt file: fall through to re-derive
    if bloom is None:
        # older cache (or torn write): derive from the occupied rec rows and
        # persist ATOMICALLY — in multi-process deployments several workers
        # load the same DB dir concurrently, and a plain np.save could be
        # read half-written by a sibling (a partial filter would introduce
        # Bloom false negatives -> misclassification).  tmp + os.replace
        # keeps every reader seeing either no file or a complete one.
        occ = rec[:, 0] != EMPTY_HI
        bloom = build_bloom(rec[occ, 0], rec[occ, 1], int(m["s4"]), int(m["s5"]))
        if bloom is not None:
            try:
                # np.save appends ".npy" when missing — keep the suffix so
                # the tmp name is exactly what os.replace moves
                tmp = bpath + f".tmp{os.getpid()}.npy"
                with open(tmp, "wb") as fh:
                    np.save(fh, bloom)
                os.replace(tmp, bpath)
            except OSError:
                pass  # read-only cache dir: keep the in-memory filter
    return FpDB(
        fptab=arr("fptab"), fptab2=arr("fptab2"), rec=rec,
        nb=int(m["nb"]), nb2=int(m["nb2"]),
        s1=int(m["s1"]), s2=int(m["s2"]), s3=int(m["s3"]),
        s4=int(m["s4"]), s5=int(m["s5"]),
        slot_target=np.asarray(arr("slot_target")),
        slot_idx=np.asarray(arr("slot_idx")),
        bloom=bloom,
    )


def _fps_of(fptab32: np.ndarray) -> np.ndarray:
    """[nb, 4] u32 -> [nb, 8] int64 fps in device slot order (half*4+word)."""
    return np.stack(
        [
            (fptab32 >> np.uint32(16 * half))[:, w] & np.uint32(0xFFFF)
            for half in (0, 1)
            for w in range(4)
        ],
        axis=1,
    ).astype(np.int64)


def verify_fpdb(db: FpDB, hi: np.ndarray, lo: np.ndarray) -> None:
    """Invariant check (used by tests): every key resolves through the same
    three-bucket fingerprint probe the device performs, uniquely."""
    b1, _, fp16 = fp_hashes(hi, lo, db.nb, db.s1, db.s2, db.s3)
    c1, c2, _ = fp_hashes(hi, lo, db.nb2, db.s4, db.s5, db.s3)
    fp = fp16[:, None].astype(np.int64)
    f1 = _fps_of(db.fptab)
    f2 = _fps_of(db.fptab2)
    m1 = (f1[b1] == fp).sum(1)
    m2 = (f2[c1] == fp).sum(1)
    m3 = (f2[c2] == fp).sum(1) * (c1 != c2)
    assert ((m1 + m2 + m3) >= 1).all(), "key lost"
    # per-bucket fp uniqueness, both levels
    for f in (f1, f2):
        srt = np.sort(f, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != 0)
        assert not dup.any(), "duplicate fingerprint in a bucket"
