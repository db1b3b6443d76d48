"""Sorted-array k-mer lookup: vectorized two-word binary search.

Device replacement for the reference's 24 GiB open-addressing hash table
(``newkmer_10nx.cpp:158-266``): the probe DB is a flat array of *sorted*
60-bit keys split into (hi, lo) uint32 words, and each query becomes a
branch-free lower-bound binary search — log2(N) rounds of gathers over the
whole query batch at once.  Exact-key compare gives the same exact-dictionary
semantics as the reference's probe-until-empty lookup (duplicate file keys are
resolved to the first occurrence at DB build time, matching first-insert-wins
probing).

An optional first-level bucket index over the top ``bucket_bits`` of the key
narrows the search range and cuts the gather rounds on large DBs.  This
binary-search layout is the legacy/sharded-lookup path; the production
single-chip hot path is the fingerprint-cuckoo layout (db/fpdb.py +
fp_candidates below), which replaces the log2(N) gather rounds with 2 narrow
row-gathers per window.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


def _less2(ahi, alo, bhi, blo):
    """Lexicographic (hi, lo) uint32 comparison: (a < b)."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def searchsorted2(db_hi: jax.Array, db_lo: jax.Array, q_hi: jax.Array, q_lo: jax.Array,
                  lo0: jax.Array | None = None, hi0: jax.Array | None = None,
                  steps: int | None = None) -> jax.Array:
    """Lower-bound index of each two-word query in a two-word sorted array.

    ``db_hi/db_lo`` are uint32 [N] sorted by the 60-bit key; ``q_hi/q_lo`` any
    shape.  Optional per-query ``lo0``/``hi0`` restrict the search range
    (used with the bucket index); ``steps`` bounds the bisection rounds (pass
    ceil(log2(max_range+1)) when ranges are narrower than the whole array —
    each round is 2 HBM gathers per query, the pipeline's dominant cost).
    Returns int32 indices in [0, N].
    """
    n = db_hi.shape[0]
    lo = jnp.zeros(q_hi.shape, dtype=jnp.int32) if lo0 is None else lo0.astype(jnp.int32)
    hi = jnp.full(q_hi.shape, n, dtype=jnp.int32) if hi0 is None else hi0.astype(jnp.int32)
    if n == 0:
        return lo
    if steps is None:
        steps = max(1, math.ceil(math.log2(n + 1)))

    def body(_, carry):
        lo, hi = carry
        active = lo < hi  # keep converged lanes stable across fixed steps
        mid = (lo + hi) >> 1
        mhi = jnp.take(db_hi, mid, axis=0)
        mlo = jnp.take(db_lo, mid, axis=0)
        less = _less2(mhi, mlo, q_hi, q_lo)
        return (
            jnp.where(active & less, mid + 1, lo),
            jnp.where(active & ~less, mid, hi),
        )

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi), unroll=True)
    return lo


@partial(jax.jit, static_argnames=("bucket_bits", "max_steps"))
def lookup_keys(db, q_hi: jax.Array, q_lo: jax.Array, bucket_bits: int = 0,
                max_steps: int | None = None):
    """Look up query keys in a packed DB; returns (index, found).

    ``db`` is a dict with sorted ``hi``/``lo`` uint32 [N] and, when
    ``bucket_bits > 0``, an int32 offsets array ``bucket_off`` of size
    2**bucket_bits + 1 mapping the top ``bucket_bits`` of a key to its key
    range (see db/probes.py).  ``found`` is False where the key is absent;
    ``index`` is then N (one-past-the-end sentinel).
    """
    db_hi, db_lo = db["hi"], db["lo"]
    n = db_hi.shape[0]
    if bucket_bits > 0:
        # key top bits live in hi (28 significant bits: key bits [32, 60)).
        b = (q_hi >> (28 - bucket_bits)).astype(jnp.int32)
        off = db["bucket_off"]
        lo0 = jnp.take(off, b, axis=0)
        hi0 = jnp.take(off, b + 1, axis=0)
        idx = searchsorted2(db_hi, db_lo, q_hi, q_lo, lo0, hi0, steps=max_steps)
    else:
        idx = searchsorted2(db_hi, db_lo, q_hi, q_lo, steps=max_steps)
    safe = jnp.minimum(idx, n - 1) if n > 0 else idx
    if n == 0:
        return jnp.full(q_hi.shape, 0, jnp.int32), jnp.zeros(q_hi.shape, bool)
    hit = (
        (idx < n)
        & (jnp.take(db_hi, safe, axis=0) == q_hi)
        & (jnp.take(db_lo, safe, axis=0) == q_lo)
    )
    return jnp.where(hit, idx, n), hit


# ------------------------------------------------------- fingerprint path


def take_rows(tab: jax.Array, idx: jax.Array) -> jax.Array:
    """``jnp.take(tab, idx, axis=0)`` with the index plane re-shaped to an
    [odd, 128] layout (flattened, padded to an odd multiple of 128 lanes,
    reshaped back; padding lanes gather row 0 and are sliced off).

    Used for the narrow post-compaction gathers (L1/L2 candidates, rec
    verify, tinfo).  On an H100 the finals step with this layout took the
    same device time as with a plain ``jnp.take`` and ~5% less wall time
    per step (PERF.md, Findings); why the wall time differs is not
    measured.
    """
    if idx.ndim == 0:
        return jnp.take(tab, idx, axis=0)
    shape = idx.shape
    n = 1
    for s in shape:
        n *= s
    rows = -(-n // 128)
    if rows % 2 == 0:
        rows += 1  # odd row count => total lanes = odd * 2^7
    pad = rows * 128 - n
    flat = jnp.pad(idx.reshape(-1), (0, pad)).reshape(rows, 128)
    out = jnp.take(tab, flat, axis=0)
    tail = tab.shape[1:]
    return out.reshape((rows * 128,) + tail)[:n].reshape(shape + tail)


def _fp_mix(a, b, s1, s2):
    x = a ^ (b * s1)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x2C1B3C6D)
    x = x ^ (x >> 12)
    x = x * s2
    return x ^ (x >> 16)


def fp_hashes_jnp(q_hi, q_lo, nb: int, s1, s2, s3):
    """Device twin of db/fpdb.fp_hashes (bit-identical; tested)."""
    s1 = jnp.uint32(s1)
    s2 = jnp.uint32(s2)
    s3 = jnp.uint32(s3)
    mask = jnp.uint32(nb - 1)
    b1 = (_fp_mix(q_hi, q_lo, s1, s2) & mask).astype(jnp.int32)
    b2 = (_fp_mix(q_lo, q_hi, s2, s1) & mask).astype(jnp.int32)
    m = _fp_mix(q_hi ^ jnp.uint32(0x6A09E667), q_lo, s3, s1)
    fp = (m ^ (m >> 16)) & jnp.uint32(0xFFFF)
    fp = jnp.where(fp == 0, jnp.uint32(1), fp)
    return b1, b2, fp


def bloom_hashes_jnp(q_hi, q_lo, nblk: int, s4, s5):
    """Device twin of db/fpdb.bloom_hashes (bit-identical; tested)."""
    from kmer_id_tpu.db.fpdb import BLOOM_BITS

    s4 = jnp.uint32(s4)
    s5 = jnp.uint32(s5)
    blk = (_fp_mix(q_hi ^ jnp.uint32(0x243F6A88), q_lo, s4, s5)
           & jnp.uint32(nblk - 1)).astype(jnp.int32)
    m = _fp_mix(q_lo ^ jnp.uint32(0xB7E15162), q_hi, s5, s4)
    bits = [(m >> (7 * j)) & jnp.uint32(127) for j in range(BLOOM_BITS)]
    return blk, bits


def bloom_pass(db, q_hi, q_lo, valid):
    """128-bit-block Bloom membership pre-test: bool plane, True where the
    window MIGHT be a probe (no false negatives — db/fpdb.build_bloom sets
    every one of the key's BLOOM_BITS bits; ~2.4% false-pass at 16
    keys/block with k=4).  ONE 16-byte row-gather into the ``bloom`` table
    per window — the gate that keeps the expensive L1 gather
    off ~97% of windows (engine/fpclassify)."""
    bloom = db["bloom"]
    nblk = bloom.shape[0]
    blk, bits = bloom_hashes_jnp(q_hi, q_lo, nblk, db["fp_s4"], db["fp_s5"])
    shape = blk.shape

    def test(blk, bits):
        row = jnp.take(bloom, blk, axis=0)  # [..., 4]
        wid = jax.lax.broadcasted_iota(jnp.uint32, row.shape, row.ndim - 1)
        need = jnp.zeros_like(row)
        for bit in bits:
            need = need | jnp.where(
                wid == (bit[..., None] >> 5),
                jnp.uint32(1) << (bit[..., None] & 31), jnp.uint32(0),
            )
        return jnp.all((row & need) == need, axis=-1)

    # the full-width [B, P] gather keeps the plain take: XLA fuses it with the
    # bit test, and a pad/reshape around it would break that fusion
    return valid & test(blk, bits)


def _fp_bucket_match(row, fp):
    """row uint32 [..., 4] -> (any_match, device slot index half*4+word).

    Build guarantees at most one stored fingerprint per bucket equals fp."""
    lo = row & jnp.uint32(0xFFFF)
    hi = row >> 16
    m = jnp.concatenate([lo, hi], axis=-1) == fp[..., None]
    return m.any(axis=-1), jnp.argmax(m, axis=-1).astype(jnp.int32)


def fp_candidates(db, q_hi, q_lo, valid):
    """Two-level fingerprint stage: per-window candidate slot ids.

    ONE gather into the big L1 table (single-choice) plus two gathers into
    the small L2 overflow cuckoo (db/fpdb.py module
    doc).  Returns a list of (cand, valid) planes — candidate slot id
    (bucket*8+slot; L2 offset by nb1*8) and validity per choice.  The last
    plane excludes c2 == c1 (the match would be the same slot twice).  A
    present key produces its true slot in exactly one choice; false
    candidates (~24/2^16 per miss window) are killed by the verify stage.
    """
    fptab = db["fptab"]
    fptab2 = db["fptab2"]
    nb1 = fptab.shape[0]
    nb2 = fptab2.shape[0]
    b1, _, fp = fp_hashes_jnp(q_hi, q_lo, nb1, db["fp_s1"], db["fp_s2"], db["fp_s3"])
    c1, c2, _ = fp_hashes_jnp(q_hi, q_lo, nb2, db["fp_s4"], db["fp_s5"], db["fp_s3"])
    r1 = take_rows(fptab, b1)
    r2 = take_rows(fptab2, c1)
    r3 = take_rows(fptab2, c2)
    m1, s1 = _fp_bucket_match(r1, fp)
    m2, s2 = _fp_bucket_match(r2, fp)
    m3, s3 = _fp_bucket_match(r3, fp)
    off = jnp.int32(nb1 * 8)
    return [
        (b1 * 8 + s1, m1 & valid),
        (off + c1 * 8 + s2, m2 & valid),
        (off + c2 * 8 + s3, m3 & valid & (c2 != c1)),
    ]


def _mix32_jnp(a, b, s1, s2):
    x = a ^ (b * s1)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x2C1B3C6D)
    x = x ^ (x >> 12)
    x = x * s2
    return x ^ (x >> 16)


def cuckoo_lookup(db, q_hi: jax.Array, q_lo: jax.Array):
    """Two-row-gather lookup over a cuckoo DB (db/cuckoo.py layout).

    Returns (target, index, found): ``index`` is the probe's position in the
    canonical sorted order (carried in the slot rows), ``n`` sentinel on miss
    — drop-in for the sorted-array contract.
    """
    table = db["cuckoo"]  # uint32 [nb, 16]
    nb = table.shape[0]
    # n / salts may be traced scalars (they ride in the arg pytree)
    n = db["n_probes"]
    s1 = jnp.uint32(db["cuckoo_s1"])
    s2 = jnp.uint32(db["cuckoo_s2"])
    mask = jnp.uint32(nb - 1)
    h1 = (_mix32_jnp(q_hi, q_lo, s1, s2) & mask).astype(jnp.int32)
    h2 = (_mix32_jnp(q_lo, q_hi, s1, s2) & mask).astype(jnp.int32)
    r1 = jnp.take(table, h1, axis=0)
    r2 = jnp.take(table, h2, axis=0)
    rows = jnp.concatenate([r1, r2], axis=-1).reshape(*q_hi.shape, 8, 4)
    hit = (rows[..., 0] == q_hi[..., None]) & (rows[..., 1] == q_lo[..., None])
    found = hit.any(-1)
    slot = jnp.argmax(hit, axis=-1)
    row = jnp.take_along_axis(rows, slot[..., None, None], axis=-2)[..., 0, :]
    tgt = jnp.where(found, row[..., 2].astype(jnp.int32), 0)
    idx = jnp.where(found, row[..., 3].astype(jnp.int32), n)
    return tgt, idx, found
