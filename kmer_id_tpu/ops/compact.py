"""Candidate compaction: first-``max_hits`` selection in window order.

The fp engine's candidate stage (ops/lookup.fp_candidates) yields up to three
sparse candidate planes per batch ([B, P] slot ids + validity).  The verify
stage only needs the first ``max_hits`` candidates of each read **in window
order** (ascending window position; ties across planes in plane order — the
order the reference's per-window loop would discover them,
``newkmer_10nx.cpp:529-603``).

**Rank compaction** does this without a sort network or a scatter: one
cumulative-sum pass assigns each valid candidate its output rank, then
``max_hits`` masked reductions select the rank-j candidate of every row.
Selection is pure elementwise compare/select/add.  Formulations:

* :func:`compact_ranks` — jnp; XLA fuses the rank-j passes into reduction
  kernels.  The engines use this one (:func:`compact_auto`).  The [B, C]
  planes are a few MB, so the passes re-read them from the card's L2; a
  hand-written Pallas (Triton) kernel that ran the rank loop on registers
  measured the same device time on the H100 (PERF.md, Findings) and was
  not kept.
* :func:`compact_sort` — a stable multi-operand ``lax.sort``; the wide
  fallback tiers use it, and it is the oracle for the rank formulation.

Both return identical values (tests/test_compact.py asserts bit-equality).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SENT = 2**31 - 1


def interleave_planes(planes):
    """[(cand, valid)] * K -> (cand_ilv, valid_ilv) int32/bool [B, K*P].

    Column j = K*p + k holds plane k's candidate for window p, so ascending
    j is ascending (window, plane) — the reference discovery order (equal to
    the stable sort by window position over the plane-major concatenation).
    """
    cand = jnp.stack([c for c, _ in planes], axis=2)
    valid = jnp.stack([v for _, v in planes], axis=2)
    b, p, k = cand.shape
    return cand.reshape(b, p * k), valid.reshape(b, p * k)


def compact_ranks(cand_ilv, valid_ilv, pos_ilv, max_hits: int, extras=()):
    """Rank-compaction, jnp formulation.

    Args:
      cand_ilv: int32 [B, C] candidate payloads.
      valid_ilv: bool [B, C].
      pos_ilv: int32 [B, C] window position of each column (broadcastable).
      extras: additional [B, C] payload planes compacted under the SAME
        mask — the cheap way to carry per-candidate values (query key words,
        plane ids, ...) instead of re-fetching them afterwards with a
        per-row ``take_along_axis`` gather.
    Returns:
      (pos32, cand32, ncand, extras32): int32 [B, max_hits] window positions
      (``_SENT`` pad past the last candidate), int32 [B, max_hits] payloads
      (0 pad), int32 [B] total candidate count (may exceed max_hits), tuple
      of compacted extras (each [B, max_hits], 0 pad, original dtype).
    """
    b, c = cand_ilv.shape
    rank = jnp.cumsum(valid_ilv.astype(jnp.int32), axis=1)
    ncand = rank[:, -1]
    # mask rank to 0 on invalid columns so == j+1 tests hit only valid ones
    rankv = jnp.where(valid_ilv, rank, 0)
    extras = tuple(jnp.broadcast_to(e, (b, c)) for e in extras)
    cols = []
    for j in range(max_hits):
        m = rankv == (j + 1)
        cols.append(
            (
                jnp.sum(jnp.where(m, pos_ilv, 0), axis=1),
                jnp.sum(jnp.where(m, cand_ilv, 0), axis=1),
            )
            + tuple(
                jnp.sum(jnp.where(m, e, jnp.zeros((), e.dtype)), axis=1)
                for e in extras
            )
        )
    pos32 = jnp.stack([col[0] for col in cols], axis=1)
    cand32 = jnp.stack([col[1] for col in cols], axis=1)
    extras32 = tuple(
        jnp.stack([col[2 + i] for col in cols], axis=1)
        for i in range(len(extras))
    )
    has = jax.lax.broadcasted_iota(jnp.int32, pos32.shape, 1) < ncand[:, None]
    pos32 = jnp.where(has, pos32, jnp.int32(_SENT))
    return pos32, cand32, ncand, extras32


def compact_sort(cand_ilv, valid_ilv, pos_ilv, max_hits: int, extras=()):
    """The sort formulation (stable multi-operand lax.sort): one pass at any
    budget, so the rare dense/overflow fallback tiers use it; also the oracle
    for the rank formulations in tests.  Outputs are canonicalized to match
    compact_ranks bit-for-bit (0 pads)."""
    b, c = cand_ilv.shape
    # ascending interleaved column index IS (window, plane) order
    keys = jnp.where(
        valid_ilv,
        jax.lax.broadcasted_iota(jnp.int32, (b, c), 1),
        jnp.int32(_SENT),
    )
    posb = jnp.broadcast_to(pos_ilv, (b, c)).astype(jnp.int32)
    exb = [jnp.broadcast_to(e, (b, c)) for e in extras]
    srt = jax.lax.sort(
        (keys, cand_ilv.astype(jnp.int32), posb, *exb), dimension=1,
        num_keys=1, is_stable=True,
    )
    k = srt[0][:, :max_hits]
    has = k < _SENT
    cand32 = jnp.where(has, srt[1][:, :max_hits], 0)
    pos32 = jnp.where(has, srt[2][:, :max_hits], jnp.int32(_SENT))
    extras32 = tuple(
        jnp.where(has, e[:, :max_hits], jnp.zeros((), e.dtype))
        for e in srt[3:]
    )
    ncand = valid_ilv.sum(axis=1).astype(jnp.int32)
    return pos32, cand32, ncand, extras32


# ------------------------------------------------------------- dispatcher


def compact_auto(cand_ilv, valid_ilv, pos_ilv, max_hits: int, extras=()):
    """Engine entry point: the one compaction formulation the engines use
    (fused jnp reductions; see the module doc for why)."""
    return compact_ranks(cand_ilv, valid_ilv, pos_ilv, max_hits, extras=extras)
