"""Vectorized taxonomy queries and the ordered per-read MSCA fold.

The classifier folds each read's k-mer hits into one taxonomy node with
``final = msca(target, final)`` (``newkmer_10nx.cpp:588-595``).  ``msca`` is
commutative but **not associative**: a fold mixing incomparable hits (which
resolve to an LCA) with deeper hits (which re-descend) depends on hit order.
Exact parity therefore requires folding hits in the reference's order —
ascending k-mer end position, reads in file order.  We keep the fold exact by
scanning positions left-to-right with a [batch]-wide carry: the scan is
sequential over ≤ L-29 tiny steps, but each step is a fully vectorized
msca over the whole batch (a handful of gathers into the ancestor table), so
the batch dimension keeps the device busy.

``msca``/``lca`` are computed from the ancestor-at-depth table built in
core/taxonomy.py — O(1) gathers for comparability tests and a log2(max_depth)
binary search for LCA, instead of the reference's pointer-chasing set walks.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def _anc_at(anc: jax.Array, node: jax.Array, d: jax.Array) -> jax.Array:
    """anc[node, d] with clipped gather indices."""
    dcl = jnp.clip(d, 0, anc.shape[1] - 1)
    return anc[node, dcl]


def _is_anc_or_self(anc, depth, y, x):
    """True where y is an ancestor of x or y == x."""
    dy = depth[y]
    return (dy <= depth[x]) & (_anc_at(anc, x, dy) == y)


def lca_jnp(anc: jax.Array, depth: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Lowest common ancestor-or-self (builder ``ca``, kmer_build_vf6.cpp:99-118)."""
    dmin = jnp.minimum(depth[x], depth[y])
    lo = jnp.zeros_like(dmin)  # depth 0 (root) is always common
    hi = dmin
    steps = max(1, math.ceil(math.log2(anc.shape[1] + 1)) + 1)
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        same = _anc_at(anc, x, mid) == _anc_at(anc, y, mid)
        lo = jnp.where(same, mid, lo)
        hi = jnp.where(same, hi, mid - 1)
    return _anc_at(anc, x, lo)


def msca_jnp(anc: jax.Array, depth: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Classifier fold op (``newkmer_10nx.cpp:118-144``), batch-vectorized.

    Comparable pairs resolve to the descendant (more specific node);
    incomparable pairs to their LCA.  Arguments must be valid node ids
    (callers guard the 0 = "no hit" sentinel).
    """
    n = anc.shape[0]
    x = jnp.clip(x, 0, n - 1)
    y = jnp.clip(y, 0, n - 1)
    y_anc_x = _is_anc_or_self(anc, depth, y, x)
    x_anc_y = _is_anc_or_self(anc, depth, x, y)
    return jnp.where(y_anc_x, x, jnp.where(x_anc_y, y, lca_jnp(anc, depth, x, y)))


def compact_hits(anc: jax.Array, depth: jax.Array, targets: jax.Array, max_hits: int):
    """Scan-free per-read hit summarization (the production fold path).

    For each read row of per-window targets (0 = miss), computes:

    * ``hits`` int32 [B, max_hits] — the first ``max_hits`` hit targets in
      window order (rank-compaction scatter, no sequential scan);
    * ``nhits`` int32 [B] — total hits (may exceed ``max_hits``);
    * ``deepest`` int32 [B] — a maximum-depth hit;
    * ``consistent`` bool [B] — True iff every hit is an ancestor-or-self of
      ``deepest``, i.e. the hit set lies on one root chain.  Then the
      reference's sequential msca fold provably returns ``deepest``
      (comparable pairs resolve to the deeper node at every step), so the
      final call is order-free and fully resolved on device.

    Inconsistent or overflowing rows (rare on real DBs, where probes are
    spaced >= 31 bases apart per genome) are folded exactly on the host from
    ``hits``/the full target plane; see engine.classify.resolve_finals.
    """
    b, p = targets.shape
    t = targets.astype(jnp.int32)
    hitm = t > 0
    rank = jnp.cumsum(hitm.astype(jnp.int32), axis=1)
    nhits = rank[:, -1]
    slot = jnp.where(hitm & (rank <= max_hits), rank - 1, max_hits)
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, p), 0)
    hits = jnp.zeros((b, max_hits + 1), jnp.int32)
    hits = hits.at[rows, slot].set(t, mode="promise_in_bounds")[:, :max_hits]

    d = jnp.where(hitm, depth[jnp.clip(t, 0, depth.shape[0] - 1)], -1)
    arg = jnp.argmax(d, axis=1)
    deepest = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
    anc_ok = _is_anc_or_self(anc, depth, jnp.clip(t, 0, anc.shape[0] - 1),
                             jnp.clip(deepest[:, None], 0, anc.shape[0] - 1))
    consistent = jnp.all(anc_ok | ~hitm, axis=1)
    # Pack into ONE [B, max_hits+3] i32 plane: a single device->host transfer
    # per batch (tiny separate transfers are pathologically slow through some
    # PJRT transports).  Columns: 0=deepest, 1=nhits, 2=consistent, 3:=hits.
    return jnp.concatenate(
        [
            deepest[:, None].astype(jnp.int32),
            nhits[:, None].astype(jnp.int32),
            consistent[:, None].astype(jnp.int32),
            hits,
        ],
        axis=1,
    )


def fold_targets_interval(chain3: jax.Array, targets: jax.Array) -> jax.Array:
    """Ordered per-read msca fold via ancestor-chain intervals — the cheap
    device formulation used by the fp engine's inconsistent-read branch.

    Semantically identical to :func:`fold_targets` (tested equal), but
    restructured to cut per-step work: ``fold_targets``'s scan step runs
    ~15 *separate* gather kernels (is-ancestor checks + an LCA binary
    search); here ALL taxonomy data is pre-gathered in one pass
    ([B, P, D, 3] ancestor-chain rows from the small ``chain3`` table,
    core/taxonomy.chain_tables) and each scan step is pure elementwise
    interval math plus one take_along_axis:

    * descend (f ancestor-or-self of t): ``ftin <= ttin <= ftout``;
    * stay (t ancestor of f): ``ttin <= ftin <= ttout``;
    * else LCA = the deepest entry of f's carried ancestor chain whose
      interval contains t — the qualifying entries are a prefix of the
      chain (ancestor intervals nest), so it's ``sum(qualify) - 1``.

    Matches the reference's ``msca(target, final)`` including the equal-node
    case (descend wins, returning x=target; ``newkmer_10nx.cpp:118-144``).

    Args:
      chain3: int32 [n, D, 3] from Taxonomy.chain_tables().
      targets: int32 [B, P] per-window targets in window order, 0 = miss.

    Returns: int32 [B] final target (0 = unclassified).
    """
    b, p = targets.shape
    n, d, _ = chain3.shape
    t = jnp.clip(targets, 0, n - 1)
    rows = jnp.take(chain3, t.reshape(-1), axis=0).reshape(b, p, d, 3)
    # each node's own (tin, tout) = the deepest valid chain entry; rather
    # than a second table gather, read it from the row at the node's depth:
    # entries beyond depth are (0, INT32_MAX, -1) so a max over valid tins
    # with the invalid sentinel masked gives tin; simpler: qualify-count of
    # t against its own chain is depth[t]+1 and the entry there is t itself.
    # We just take the per-window interval from the deepest valid entry.
    valid_e = rows[:, :, :, 2] >= 0  # [B, P, D]
    last = jnp.maximum(valid_e.sum(axis=2) - 1, 0)  # own depth
    own = jnp.take_along_axis(rows, last[:, :, None, None], axis=2)[:, :, 0, :]
    ttin_all = own[:, :, 1]  # [B, P]
    ttout_all = own[:, :, 2]

    sent = jnp.int32(2**31 - 1)
    f0 = jnp.zeros((b,), jnp.int32)
    ftin0 = jnp.full((b,), sent)
    ftout0 = jnp.full((b,), -1, jnp.int32)
    chain0 = jnp.zeros((b, d, 3), jnp.int32).at[:, :, 1].set(sent)
    chain0 = chain0.at[:, :, 2].set(-1)

    def step(carry, x):
        f, ftin, ftout, chain = carry
        tcol, ttin, ttout, tchain = x
        has = tcol > 0
        fnone = f == 0
        descend = (ftin <= ttin) & (ttin <= ftout)
        stay = (ttin <= ftin) & (ftin <= ttout)
        q = (chain[:, :, 1] <= ttin[:, None]) & (ttin[:, None] <= chain[:, :, 2])
        jstar = jnp.maximum(q.sum(axis=1) - 1, 0)
        lca = jnp.take_along_axis(chain, jstar[:, None, None], axis=1)[:, 0, :]
        dmask = (
            jax.lax.broadcasted_iota(jnp.int32, (b, d), 1) <= jstar[:, None]
        )
        trunc = jnp.where(
            dmask[:, :, None],
            chain,
            jnp.stack(
                [jnp.zeros_like(chain[:, :, 0]),
                 jnp.full_like(chain[:, :, 1], sent),
                 jnp.full_like(chain[:, :, 2], -1)], axis=2,
            ),
        )
        nf = jnp.where(descend, tcol, jnp.where(stay, f, lca[:, 0]))
        nftin = jnp.where(descend, ttin, jnp.where(stay, ftin, lca[:, 1]))
        nftout = jnp.where(descend, ttout, jnp.where(stay, ftout, lca[:, 2]))
        nchain = jnp.where(
            descend[:, None, None], tchain,
            jnp.where(stay[:, None, None], chain, trunc),
        )
        adopt = has & fnone
        use = has & ~fnone
        f = jnp.where(adopt, tcol, jnp.where(use, nf, f))
        ftin = jnp.where(adopt, ttin, jnp.where(use, nftin, ftin))
        ftout = jnp.where(adopt, ttout, jnp.where(use, nftout, ftout))
        sel = jnp.where(adopt, 0, jnp.where(use, 1, 2))[:, None, None]
        chain = jnp.where(sel == 0, tchain, jnp.where(sel == 1, nchain, chain))
        return (f, ftin, ftout, chain), None

    xs = (
        jnp.transpose(t, (1, 0)),
        jnp.transpose(ttin_all, (1, 0)),
        jnp.transpose(ttout_all, (1, 0)),
        jnp.transpose(rows, (1, 0, 2, 3)),
    )
    (f, _, _, _), _ = jax.lax.scan(step, (f0, ftin0, ftout0, chain0), xs)
    return f


def fold_targets_chain(
    chain3: jax.Array,
    targets: jax.Array,
    ttin: jax.Array,
    tout: jax.Array,
) -> jax.Array:
    """Ordered per-read msca fold — the slim scan used by the fp engine.

    Semantically identical to :func:`fold_targets_interval` (tested equal) but
    restructured again to shrink the scan carry: that version carried the
    running node's full ancestor chain ([B, D, 3]) through the scan and
    pre-gathered every hit's chain ([B, P, D, 3]), paying ~3 large
    jnp.where's + a take_along_axis per step.  Observation: the carried chain
    is ALWAYS exactly ``chain3[f]`` — on adopt/descend it becomes the new
    node's chain, on stay it is unchanged, and the LCA case truncates to the
    LCA's own chain — so it never needs to be carried or truncated at all:
    re-gather ``chain3[f]`` per step (8k rows from a <2 MB table) and keep
    the carry to three [B] vectors.

    A second structural saving: each hit's own (tin, tout) interval already
    rides in the verify row the fp engine gathered (db/fpdb.py rec payload),
    so callers pass them in and the [B, P, D, 3] pre-gather disappears.

    Third — the one that actually pays (the scan is per-STEP latency-bound,
    whatever the per-step width): the trip count is DYNAMIC,
    `max(last hit column) + 1` over the batch, via lax.fori_loop (on the
    GPU a while loop whose predicate is read per step; its cost per step is
    not measured on the H100).  Callers that only need some rows folded should zero the
    other rows' targets (fp_finals zeroes consistent reads, whose fold
    result is discarded anyway): hit lists are front-compacted, so typical
    inconsistent batches scan 2-4 steps, not max_hits.

    Args:
      chain3: int32 [n, D, 3] from Taxonomy.chain_tables() — rows are
        (node, tin, tout) per ancestor depth, (0, INT32_MAX, -1) past the
        node's own depth.
      targets: int32 [B, P] per-hit targets in window order, 0 = miss.
      ttin / tout: int32 [B, P] the hits' Euler intervals (any value where
        ``targets == 0``; those lanes are skipped).

    Returns: int32 [B] final target (0 = unclassified).
    """
    b, p = targets.shape
    n, d, _ = chain3.shape
    sent = jnp.int32(2**31 - 1)
    t = jnp.clip(targets, 0, n - 1)
    ttin = ttin.astype(jnp.int32)
    tout = tout.astype(jnp.int32)
    # dynamic trip count: one past the last column holding any hit
    colmax = jnp.max(
        (t > 0) * (jax.lax.broadcasted_iota(jnp.int32, (b, p), 1) + 1)
    )

    def body(i, carry):
        f, ftin, ftout = carry
        tcol = jax.lax.dynamic_slice_in_dim(t, i, 1, axis=1)[:, 0]
        tin_c = jax.lax.dynamic_slice_in_dim(ttin, i, 1, axis=1)[:, 0]
        tout_c = jax.lax.dynamic_slice_in_dim(tout, i, 1, axis=1)[:, 0]
        has = tcol > 0
        fnone = f == 0
        descend = (ftin <= tin_c) & (tin_c <= ftout)
        stay = (tin_c <= ftin) & (ftin <= tout_c)
        chainF = jnp.take(chain3, f, axis=0)  # [B, D, 3] small-table gather
        q = (chainF[:, :, 1] <= tin_c[:, None]) & (tin_c[:, None] <= chainF[:, :, 2])
        jstar = jnp.maximum(q.sum(axis=1) - 1, 0)
        lca = jnp.take_along_axis(chainF, jstar[:, None, None], axis=1)[:, 0, :]
        nf = jnp.where(descend, tcol, jnp.where(stay, f, lca[:, 0]))
        nftin = jnp.where(descend, tin_c, jnp.where(stay, ftin, lca[:, 1]))
        nftout = jnp.where(descend, tout_c, jnp.where(stay, ftout, lca[:, 2]))
        adopt = has & fnone
        use = has & ~fnone
        f = jnp.where(adopt, tcol, jnp.where(use, nf, f))
        ftin = jnp.where(adopt, tin_c, jnp.where(use, nftin, ftin))
        ftout = jnp.where(adopt, tout_c, jnp.where(use, nftout, ftout))
        return (f, ftin, ftout)

    init = (
        jnp.zeros((b,), jnp.int32),
        jnp.full((b,), sent),
        jnp.full((b,), -1, jnp.int32),
    )
    f, _, _ = jax.lax.fori_loop(0, colmax, body, init)
    return f


def fold_targets(
    anc: jax.Array,
    depth: jax.Array,
    targets: jax.Array,
    init: jax.Array | None = None,
) -> jax.Array:
    """Ordered per-read fold of k-mer hit targets.

    Args:
      targets: int32 [B, P]; per-window DB target, 0 = miss/invalid window.
        Window order along P must be the read's left-to-right k-mer order.
      init: optional int32 [B] carry (0 = none) for resuming a fold across
        chunked long sequences.

    Returns:
      int32 [B] final target per read (0 = unclassified), matching the
      reference's sequential ``final = msca(target, final)`` fold.
    """
    b, p = targets.shape
    final0 = jnp.zeros((b,), jnp.int32) if init is None else init.astype(jnp.int32)

    def step(final, t):
        # final = msca(t, final) when both positive; adopt t when final == 0
        # (newkmer_10nx.cpp:588-595).
        merged = msca_jnp(anc, depth, t, final)
        new = jnp.where(t > 0, jnp.where(final > 0, merged, t), final)
        return new, None

    final, _ = jax.lax.scan(step, final0, jnp.transpose(targets).astype(jnp.int32))
    return final
