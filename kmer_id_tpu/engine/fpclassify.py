"""Fingerprint-engine classifier: the production single-chip hot path.

Per batch, ONE jit-compiled program (static [B, L]):

    packed 2-bit bases ──unpack──► codes ──extract──► (hi,lo,valid) [B,P]
      ──block-Bloom gate (1 row-gather/window)──► passing windows,
      rank-compacted to BLOOM_K per read ──fingerprint stage (L1 + L2
      row-gathers on the narrow plane, ops/lookup.fp_candidates)──►
      candidate slots ──rank-compact (window order, two-tier budget)──►
      ──verify gather (12 B rec rows: key + tin/depth; tiny tinfo map
      resolves node + tout)──► on-device final call + seen scatter ──►
      finals int32 [B] (the ONLY per-batch D2H traffic)

Design notes vs engine/classify.Classifier (the legacy sorted/cuckoo engine):

* Reads cross to the device as 2-bit packed words + a sparse exception
  list for non-ACGT bases (io/batch.py pack_codes) — ~4x fewer bytes than
  the u8 code plane.
* The per-window work is ONE gather into the 16 B/block Bloom filter; only
  the ~0.25% false-pass + true-probe windows ever touch the L1/L2
  fingerprint tables or the rec verify rows.
* All taxonomy work rides in the 12-byte verify row (db/fpdb.py): the
  consistency test `every hit is an ancestor-or-self of the deepest hit`
  is elementwise interval math; the rare inconsistent read folds on device
  via the dynamic-trip chain scan (ops/fold.fold_targets_chain) under a
  batch-level lax.cond.
* The unique-k-mer ``seen`` set (``newkmer_10nx.cpp:596-603``) is a
  device-resident int8 slot bitmap scatter-maxed inside the finals kernel;
  per-sample ucount is a histogram over it (_ucount_device).
* Reads whose *candidate* count exceeds max_hits (can only exceed the true
  hit count via ~2^-16 fingerprint flukes) and long reads use the per-window
  "slots" kernel — exact, self-contained fallbacks on the same tables.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmer_id_tpu.core.codec import KSIZE
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.fpdb import FpDB, build_fpdb
from kmer_id_tpu.db.probes import PackedDB
from kmer_id_tpu.engine.classify import PendingBatch, fold_host
from kmer_id_tpu.io.batch import Batch, LongRead
from kmer_id_tpu.ops.extract import extract_kmers
from kmer_id_tpu.ops.lookup import fp_candidates


def unpack_codes(packed: jax.Array, exc: jax.Array, l: int) -> jax.Array:
    """2-bit words + exception list -> uint8 code plane [B, L].

    ``packed`` uint32 [B, ceil(L/16)], base i of a row at word i>>4, bits
    (i&15)*2.  ``exc`` int32 [E]: flat row*L+pos of non-ACGT bases (-1 pad);
    those positions are raised to the invalid code 4 via scatter-max (the
    no-op pad value 0 never changes a 2-bit code).
    """
    b, w = packed.shape
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    codes = ((packed[:, :, None] >> shifts) & jnp.uint32(3)).astype(jnp.uint8)
    codes = codes.reshape(b, w * 16)[:, :l]
    flat = codes.reshape(-1)
    idx = jnp.clip(exc, 0, flat.shape[0] - 1)
    val = jnp.where(exc >= 0, jnp.uint8(4), jnp.uint8(0))
    flat = flat.at[idx].max(val, mode="promise_in_bounds")
    return flat.reshape(b, l)


FAST_HITS = 8  # two-tier verify: the fast tier's candidate budget
BLOOM_K = 12  # Bloom path: per-read budget of filter-passing windows.  At
# the 8-keys/block filter's ~0.25% false-pass over <= ~350 windows plus a
# handful of true probes (>= 31 bases apart per genome), the per-read pass
# count is (bounded true: probes sit >= 31 bases apart per genome, so a
# 150 bp read carries <= ~4-5 per matching genome) + Poisson(~0.3) false,
# so P(any read of a batch exceeding 12) is negligible — and every unit of
# budget is ~3 narrow L1/L2 candidate gather lanes, the stage this cap
# sizes (tools/kernel_profile.py).
# Probe-dense reads (conserved multi-genome regions) overflow the budget
# and flip their batch to the probe-every-window path, which stays exact.
LONG_HITS = 8  # long-read lane: per-chunk verified-hit budget (chunks carry
# few probes — the reference builder spaces probes >= 31 bases apart — and a
# narrow budget shrinks the summary D2H plane; overflow chunks replay exact)


_SENT = 2**31 - 1


def _cv_tier(db, hi_ilv, lo_ilv, cand_ilv, valid_ilv, pos_ilv, mh: int,
             out_mh: int, impl, seen):
    """One compaction+verify tier: compact to ``mh`` candidates, verify
    against rec, gather slot targets, and (finals path, ``seen`` not None)
    scatter the verified slots into the seen bitmap — ALL sized [B, mh], so
    the fast tier's gather/scatter lane counts stay small.  The query key
    words ride as compaction payloads (``hi_ilv``/``lo_ilv``, column-aligned
    with ``cand_ilv``) instead of being re-fetched by position with a
    per-row take_along_axis gather.  Outputs are padded to ``out_mh``
    columns (pads are unverified holes, indistinguishable from rejected
    candidates downstream).  ``impl`` is an ops/compact formulation."""
    b = cand_ilv.shape[0]
    mh = min(mh, cand_ilv.shape[1])  # plane may be narrower than the budget
    pos32, cand32, _, (qhi, qlo) = impl(
        cand_ilv, valid_ilv, pos_ilv, mh, extras=(hi_ilv, lo_ilv)
    )
    from kmer_id_tpu.ops.lookup import take_rows

    has = pos32 < _SENT
    rows = take_rows(db["rec"], cand32)
    ver = has & (rows[..., 0] == qhi) & (rows[..., 1] == qlo)
    tin = (rows[..., 2] & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
    depth = (rows[..., 2] >> 24).astype(jnp.int32)
    # (node, tout) by tin — ONE gather of the tiny tinfo map
    # (db/fpdb.build_tinfo) instead of a second big-table gather
    info = take_rows(db["tinfo"], tin)
    t = jnp.where(ver, info[..., 0], 0)
    tout = info[..., 1]
    if seen is not None:
        # every verified slot is a true hit: mark seen (idempotent
        # scatter-max; overflow reads' tail hits come from the host replay)
        sc = jnp.where(ver, cand32, 0)
        sv = jnp.where(ver, jnp.int8(1), jnp.int8(0))
        seen = seen.at[sc.reshape(-1)].max(
            sv.reshape(-1), mode="promise_in_bounds"
        )
    if mh < out_mh:
        pad = ((0, 0), (0, out_mh - mh))
        cand32 = jnp.pad(cand32, pad)
        ver = jnp.pad(ver, pad)
        tin = jnp.pad(tin, pad)
        tout = jnp.pad(tout, pad)
        depth = jnp.pad(depth, pad)
        t = jnp.pad(t, pad)
    out = (cand32, ver, tin, tout, depth, t)
    return out if seen is None else (out, seen)


def _compact_verify(db, ex, max_hits: int, seen=None):
    """Shared candidate-compaction + verify stage of the summary/finals paths.

    Compacts the <=3P fingerprint candidates of each read into window order
    (rank compaction, ops/compact.py: cumsum assigns output ranks, masked
    reductions select the rank-j candidate) and verifies them against the
    full 60-bit keys in ``rec``.

    **Two-tier verify**: the verify/slot-target gathers and the compaction
    passes all scale with the candidate budget, and real reads carry <= ~5
    candidates (probes are >= 31 bases apart per genome; fingerprint flukes
    add ~24/2^16 per window) — so the hot tier compacts/verifies only
    ``FAST_HITS`` candidates, and a batch-level ``lax.cond`` reruns the full
    ``max_hits`` tier (the sort formulation, one pass at any width) only
    when any read's candidate count exceeds the fast budget.  Exactness is
    unconditional: the tier taken always covers every candidate of every
    read, and beyond ``max_hits`` the existing overflow flag triggers the
    host's per-window replay.  Returns a dict of per-read tensors consumed
    by fp_summary / fp_finals.
    """
    from kmer_id_tpu.ops.compact import (
        compact_auto,
        compact_sort,
        interleave_planes,
    )
    from kmer_id_tpu.ops.lookup import bloom_pass

    hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
    b, p = hi.shape

    def _tiered(qhi, qlo, cand_ilv, valid_ilv, pos_ilv):
        """Inner fast/slow tier selection on an interleaved candidate plane.
        ``qhi``/``qlo`` are the query-key planes of the candidate domain
        ([B, C/planes]); they are column-replicated to ride as compaction
        payloads."""
        k = cand_ilv.shape[1] // qhi.shape[1]
        hi_ilv = jnp.repeat(qhi, k, axis=1)
        lo_ilv = jnp.repeat(qlo, k, axis=1)
        ncand = valid_ilv.sum(axis=1).astype(jnp.int32)
        args = (db, hi_ilv, lo_ilv, cand_ilv, valid_ilv, pos_ilv)
        if max_hits > FAST_HITS:
            res = jax.lax.cond(
                jnp.max(ncand) > FAST_HITS,
                lambda: _cv_tier(*args, max_hits, max_hits, compact_sort, seen),
                lambda: _cv_tier(*args, FAST_HITS, max_hits, compact_auto, seen),
            )
        else:
            res = _cv_tier(*args, max_hits, max_hits, compact_auto, seen)
        return res, ncand

    def _full_planes():
        planes = fp_candidates(db, hi, lo, valid)
        ci, vi = interleave_planes(planes)
        pos_ilv = jax.lax.broadcasted_iota(
            jnp.int32, (1, ci.shape[1]), 1
        ) // len(planes)
        return ci, vi, pos_ilv

    if "bloom" in db:
        # Bloom gate: ONE gather per window decides which windows
        # see the expensive L1 gather at all; passing windows (~true probes
        # + ~5% false-pass) are rank-compacted to BLOOM_K per read — with
        # their key words as compaction payloads — and only those probe
        # L1/L2.  A read passing more than BLOOM_K windows flips the batch
        # to the probe-every-window path (real reads carry <= ~5 probe
        # windows; > 32 implies a probe-dense artificial read, which that
        # path + the overflow replay already handle exactly).
        bloomed = bloom_pass(db, hi, lo, valid)
        npass = bloomed.sum(axis=1).astype(jnp.int32)

        def bloom_path():
            iota_p = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)
            wpos, _, _, (whi, wlo) = compact_auto(
                jnp.broadcast_to(iota_p, (b, p)), bloomed, iota_p, BLOOM_K,
                extras=(hi, lo),
            )
            wvalid = wpos < _SENT
            wp = jnp.where(wvalid, wpos, 0)
            planes = fp_candidates(db, whi, wlo, wvalid)
            ci, vi = interleave_planes(planes)
            pos2 = jnp.repeat(wp, len(planes), axis=1)
            return _tiered(whi, wlo, ci, vi, pos2)

        def dense_path():
            ci, vi, pos_ilv = _full_planes()
            k = ci.shape[1] // p
            ncand = vi.sum(axis=1).astype(jnp.int32)
            out = _cv_tier(
                db, jnp.repeat(hi, k, axis=1), jnp.repeat(lo, k, axis=1),
                ci, vi, pos_ilv, max_hits, max_hits, compact_sort, seen,
            )
            return out, ncand

        res, ncand = jax.lax.cond(
            jnp.max(npass) > BLOOM_K, dense_path, bloom_path
        )
    else:
        ci, vi, pos_ilv = _full_planes()
        res, ncand = _tiered(hi, lo, ci, vi, pos_ilv)
    if seen is None:
        cand32, ver, tin, tout, depth, t = res
    else:
        (cand32, ver, tin, tout, depth, t), seen = res
    nh = ver.sum(axis=1).astype(jnp.int32)
    dkey = jnp.where(ver, depth, -1)
    j = jnp.argmax(dkey, axis=1)
    deepest = jnp.take_along_axis(cand32, j[:, None], axis=1)[:, 0]
    dtin = jnp.take_along_axis(tin, j[:, None], axis=1)[:, 0]
    # the deepest hit's target node, read from the already-resolved t plane
    # (no slot_target table on device)
    dtgt = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
    ok = ~ver | ((tin <= dtin[:, None]) & (dtin[:, None] <= tout))
    consistent = jnp.all(ok, axis=1)
    overflow = ncand > max_hits
    out = {
        "cand": cand32, "ver": ver, "nh": nh, "deepest": deepest,
        "consistent": consistent, "overflow": overflow, "dtgt": dtgt,
        "tin": tin, "tout": tout, "t": t, "depth": depth,
    }
    return out if seen is None else (out, seen)


def _summary_plane(cv):
    ver, nh = cv["ver"], cv["nh"]
    flags = cv["consistent"].astype(jnp.int32) | (
        cv["overflow"].astype(jnp.int32) << 1
    )
    slots_out = jnp.where(ver, cv["cand"], -1)
    deepest = jnp.where(nh > 0, cv["deepest"], -1)
    return jnp.concatenate(
        [deepest[:, None], nh[:, None], flags[:, None], slots_out], axis=1
    )


def fp_summary(db, ex, max_hits: int):
    """Candidate compaction + verify + per-read summary (see module doc).

    Returns int32 [B, 3+max_hits]: col0 deepest-hit slot (-1 if none), col1
    verified hit count, col2 flags (bit0 consistent, bit1 candidate
    overflow), col3.. verified slot ids in window order (-1 holes where a
    false candidate was rejected).
    """
    return _summary_plane(_compact_verify(db, ex, max_hits))


def fp_summary_seen(db, ex, seen, max_hits: int):
    """fp_summary + the unique-k-mer seen scatter fused into the same kernel
    (the long-read lane's workhorse: one dispatch does verify + scatter, and
    only the compact summary plane crosses device->host)."""
    cv, seen = _compact_verify(db, ex, max_hits, seen)
    return _summary_plane(cv), seen


def fp_long_finals(db, ex, seg, seen, n_segs: int, max_hits: int):
    """Long-read lane: per-READ finals computed ON DEVICE from chunk rows.

    ``seg`` int32 [rows] maps each chunk row to its read (rows of a read are
    contiguous; pad rows carry seg = n_segs - 1 with length 0).  The
    consistent fast path — every hit an ancestor-or-self of the segment's
    deepest hit — is pure segment arithmetic, so the only D2H traffic is
    ONE int32 per read instead of a (3 + LONG_HITS)-int summary per CHUNK
    (~40x less, and no host slot->read assembly).  Reads that are
    inconsistent OR candidate-overflowed get bit 30 set and take the exact
    per-window replay + ordered host fold, exactly like the short-read
    engine's overflow fallback.

    Reads that are inconsistent (multi-target contigs — COMMON for
    genome-scale FASTA) or candidate-overflowed get bit 30 set; the host
    resolves them from the per-chunk summary plane this kernel ALSO
    returns — fetched only for groups that contain flagged reads, so
    consistent-read groups ship one int per read and flagged groups ship
    their per-chunk summaries (no second kernel pass).

    Returns (finals int32 [n_segs], summary int32 [rows, 3+max_hits], seen).
    """
    cv, seen = _compact_verify(db, ex, max_hits, seen)
    ver, t, tin, tout, depth = cv["ver"], cv["t"], cv["tin"], cv["tout"], cv["depth"]
    nh_seg = jax.ops.segment_sum(
        cv["nh"], seg, num_segments=n_segs, indices_are_sorted=True
    )
    # deepest hit per segment: max of (depth << 24 | tin) over verified hits
    # (under consistency the max-depth NODE is unique, so this selects the
    # same target the single-read argmax does)
    dkey = jnp.where(ver, (depth << 24) | tin, -1)
    seg_dkey = jax.ops.segment_max(
        jnp.max(dkey, axis=1), seg, num_segments=n_segs,
        indices_are_sorted=True,
    )
    dtin_seg = jnp.maximum(seg_dkey, 0) & ((1 << 24) - 1)
    dtin_row = jnp.take(dtin_seg, seg, axis=0)[:, None]
    ok = ~ver | ((tin <= dtin_row) & (dtin_row <= tout))
    row_ok = jnp.all(ok, axis=1) & ~cv["overflow"]
    seg_ok = jax.ops.segment_min(
        row_ok.astype(jnp.int32), seg, num_segments=n_segs,
        indices_are_sorted=True,
    ) > 0
    # deepest target: tinfo is tin-indexed (node, tout)
    from kmer_id_tpu.ops.lookup import take_rows

    dtgt = take_rows(db["tinfo"], dtin_seg)[:, 0]
    finals = jnp.where(nh_seg > 0, dtgt, 0)
    finals = jnp.where(seg_ok, finals, finals | jnp.int32(1 << 30))
    return finals, _summary_plane(cv), seen


@partial(jax.jit, static_argnames=("l", "n_segs", "max_hits"),
         donate_argnums=(5,))
def _fp_long_packed(db, packed, exc, lengths, seg, seen, l: int, n_segs: int,
                    max_hits: int):
    codes = unpack_codes(packed, exc, l)
    ex = extract_kmers(codes, lengths)
    return fp_long_finals(db, ex, seg, seen, n_segs, max_hits)


@partial(jax.jit, static_argnames=("n_segs", "max_hits"), donate_argnums=(4,))
def _fp_long_codes(db, codes, lengths, seg, seen, n_segs: int, max_hits: int):
    ex = extract_kmers(codes, lengths)
    return fp_long_finals(db, ex, seg, seen, n_segs, max_hits)


def fp_slots(db, ex):
    """Per-window verified slot ids (int32 [B, P], -1 = miss) — the exact
    fallback for candidate-overflow reads and the long-read chunk path."""
    hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
    rec = db["rec"]
    planes = fp_candidates(db, hi, lo, valid)

    from kmer_id_tpu.ops.lookup import take_rows

    def verify(cand, cv):
        rows = take_rows(rec, cand)
        return cv & (rows[..., 0] == hi) & (rows[..., 1] == lo)

    out = jnp.full_like(hi, -1, dtype=jnp.int32)
    for cand, cv in planes:  # at most one plane verifies per window
        out = jnp.where(verify(cand, cv), cand, out)
    return out


def fp_finals(db, ex, seen, max_hits: int):
    """Fully device-resident per-read resolution (the production path).

    Computes everything ``fp_summary`` does, then *finishes the read on
    device*: the final taxonomy call (consistent fast path = deepest hit's
    target; otherwise the exact window-ordered msca fold via
    ops/fold.fold_targets) and the unique-k-mer ``seen`` scatter.  The
    device→host traffic per read shrinks from the (3+max_hits)-int summary
    row to ONE int32: the final target, with bit 30 flagging the rare
    candidate-overflow reads the host must replay through ``fp_slots``.

    Returns (finals int32 [B], seen int8 [n_slots]).
    """
    b = ex["hi"].shape[0]
    cv, seen = _compact_verify(db, ex, max_hits, seen)
    nh = cv["nh"]
    deepest, consistent, overflow = cv["deepest"], cv["consistent"], cv["overflow"]

    # final call: consistent reads take the deepest hit's target; the rest get
    # the exact window-ordered msca fold (holes/misses are 0 and are skipped).
    # The fold runs under a batch-level lax.cond: virtually all real reads are
    # consistent (probes are >= 31 bases apart per genome), so the scan is
    # usually skipped entirely at runtime.  fold_targets_chain reads each
    # hit's (tin, tout) straight from the verify rows — no chain pre-gather.
    # (The seen scatter and the slot->target gather ride inside the verify
    # tier, sized to its candidate budget; see _cv_tier.)
    from kmer_id_tpu.ops.fold import fold_targets_chain

    t = cv["t"]
    dtgt = cv["dtgt"]
    need_fold = jnp.any(~consistent & (nh > 0))
    # consistent rows' fold results are discarded below — zero their hits so
    # the fold's dynamic trip count tracks only the inconsistent rows
    t_fold = jnp.where(consistent[:, None], 0, t)
    folded = jax.lax.cond(
        need_fold,
        lambda: fold_targets_chain(db["chain3"], t_fold, cv["tin"], cv["tout"]),
        lambda: jnp.zeros((b,), jnp.int32),
    )
    finals = jnp.where(consistent, jnp.where(nh > 0, dtgt, 0), folded)
    finals = jnp.where(overflow, finals | jnp.int32(1 << 30), finals)
    return finals, seen


@partial(jax.jit, static_argnames=("l", "max_hits", "mode"))
def _fp_kernel_packed(db, packed, exc, lengths, l: int, max_hits: int, mode: str):
    codes = unpack_codes(packed, exc, l)
    ex = extract_kmers(codes, lengths)
    if mode == "summary":
        return fp_summary(db, ex, max_hits)
    return fp_slots(db, ex)


@partial(jax.jit, static_argnames=("max_hits", "mode"))
def _fp_kernel_codes(db, codes, lengths, max_hits: int, mode: str):
    ex = extract_kmers(codes, lengths)
    if mode == "summary":
        return fp_summary(db, ex, max_hits)
    return fp_slots(db, ex)


@partial(jax.jit, static_argnames=("l", "max_hits"), donate_argnums=(4,))
def _fp_sum_seen_packed(db, packed, exc, lengths, seen, l: int, max_hits: int):
    codes = unpack_codes(packed, exc, l)
    ex = extract_kmers(codes, lengths)
    return fp_summary_seen(db, ex, seen, max_hits)


@partial(jax.jit, static_argnames=("max_hits",), donate_argnums=(3,))
def _fp_sum_seen_codes(db, codes, lengths, seen, max_hits: int):
    ex = extract_kmers(codes, lengths)
    return fp_summary_seen(db, ex, seen, max_hits)


@partial(jax.jit, static_argnames=("l", "max_hits"), donate_argnums=(4,))
def _fp_finals_packed(db, packed, exc, lengths, seen, l: int, max_hits: int):
    codes = unpack_codes(packed, exc, l)
    ex = extract_kmers(codes, lengths)
    return fp_finals(db, ex, seen, max_hits)


@partial(jax.jit, static_argnames=("max_hits",), donate_argnums=(3,))
def _fp_finals_codes(db, codes, lengths, seen, max_hits: int):
    ex = extract_kmers(codes, lengths)
    return fp_finals(db, ex, seen, max_hits)


@partial(jax.jit, donate_argnums=(0,))
def _scatter_plane_seen(seen, plane):
    """Mark every verified slot of a [R, P] slots plane (-1 = miss)."""
    v = jnp.where(plane >= 0, jnp.int8(1), jnp.int8(0))
    idx = jnp.maximum(plane, 0)
    return seen.at[idx.reshape(-1)].max(v.reshape(-1), mode="promise_in_bounds")


@partial(jax.jit, donate_argnums=(0,))
def _scatter_summary_seen(seen, summary):
    """Mark the verified slots listed in a summary plane (cols 3.., -1 holes)."""
    slots = summary[:, 3:]
    v = jnp.where(slots >= 0, jnp.int8(1), jnp.int8(0))
    idx = jnp.maximum(slots, 0)
    return seen.at[idx.reshape(-1)].max(v.reshape(-1), mode="promise_in_bounds")


@jax.jit
def _slot_nodes(rec, tinfo):
    """One-time [nslots] target-node vector from the rec tin labels (a 1-D
    gather of the node column)."""
    tin = (rec[:, 2] & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
    return jnp.take(tinfo[:, 0], tin, axis=0)


def target_histogram(mask, node, num_targ: int):
    """Per-target count of the slots where ``mask`` holds: an int32
    scatter-add over the set slots only (unset slots index one past the end
    and are dropped, so they issue no add).  Integer adds commute, so the
    count is exact at any size and in any order.  Also the sharded engine's
    in-mesh finalize."""
    idx = jnp.where(mask, node, num_targ)
    return jnp.zeros((num_targ,), jnp.int32).at[idx].add(1, mode="drop")


@partial(jax.jit, static_argnames=("num_targ",))
def _ucount_device(seen, node, num_targ: int):
    """Per-target unique-k-mer counts from the seen bitmap."""
    return target_histogram((seen > 0) & (node > 1), node, num_targ)


def device_tables(f: FpDB, taxonomy: Taxonomy) -> dict:
    """Host arrays and salts of the engine's device-resident DB dict (the
    ``db`` argument of every kernel above)."""
    import os

    from kmer_id_tpu.db.fpdb import build_tinfo

    tabs = {
        "fptab": f.fptab,
        "fptab2": f.fptab2,
        "rec": f.rec,
        "fp_s1": np.uint32(f.s1),
        "fp_s2": np.uint32(f.s2),
        "fp_s3": np.uint32(f.s3),
        "fp_s4": np.uint32(f.s4),
        "fp_s5": np.uint32(f.s5),
        "tinfo": build_tinfo(taxonomy),
        "chain3": taxonomy.chain_tables()[0],
    }
    if f.bloom is not None and os.environ.get("KMER_BLOOM", "1") != "0":
        tabs["bloom"] = np.ascontiguousarray(f.bloom)
    return tabs


class FpClassifier:
    """Drop-in engine with the Classifier outer API (engine/classify.py):
    ``new_seen`` / ``submit_batch`` / ``collect`` / ``process_batch`` /
    ``process_long`` / ``ucount``.  ``seen`` is a host bool bitmap over slot
    ids (reset per sample = the reference's ``kmer_seen.clear()``,
    ``newkmer_10nx.cpp:1019``)."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        batch_size: int = 8192,
        max_len: int = 512,
        max_hits: int = 32,
        fpdb: FpDB | None = None,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.packed_db = db
        self.taxonomy = taxonomy
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_hits = max_hits
        self.num_targ = db.num_targ
        f = fpdb if fpdb is not None else build_fpdb(db, taxonomy)
        self.fpdb = f
        self.slot_target = f.slot_target
        self.slot_idx = f.slot_idx
        self.n_probes = len(db)
        self._db = {k: jnp.asarray(v) for k, v in device_tables(f, taxonomy).items()}
        self._slot_node = None  # [nslots] device target-node map (lazy)

    # ------------------------------------------------------------ state
    def new_seen(self) -> jax.Array:
        """Device-resident unique-k-mer set: int8 per slot, scatter-maxed in
        the finals kernel (= the reference's per-sample ``kmer_seen`` set,
        ``newkmer_10nx.cpp:1019``); only pulled at finalize."""
        return jnp.zeros(self.fpdb.n_slots, dtype=jnp.int8)

    # ------------------------------------------------------------ steps
    def _launch(self, batch: Batch, mode: str):
        lengths = jnp.asarray(batch.lengths)
        if getattr(batch, "packed", None) is not None:
            return _fp_kernel_packed(
                self._db, jnp.asarray(batch.packed), jnp.asarray(batch.exc),
                lengths, l=batch.codes.shape[1] if batch.codes is not None
                else self.max_len, max_hits=self.max_hits, mode=mode,
            )
        return _fp_kernel_codes(
            self._db, jnp.asarray(batch.codes), lengths,
            max_hits=self.max_hits, mode=mode,
        )

    def _launch_finals(self, seen, batch: Batch):
        lengths = jnp.asarray(batch.lengths)
        if getattr(batch, "packed", None) is not None:
            return _fp_finals_packed(
                self._db, jnp.asarray(batch.packed), jnp.asarray(batch.exc),
                lengths, seen, l=batch.codes.shape[1] if batch.codes is not None
                else self.max_len, max_hits=self.max_hits,
            )
        return _fp_finals_codes(
            self._db, jnp.asarray(batch.codes), lengths, seen,
            max_hits=self.max_hits,
        )

    def submit_batch(self, seen, batch: Batch):
        finals, seen = self._launch_finals(seen, batch)
        return seen, PendingBatch(finals, batch, None, batch.n_rows)

    def _finish_collect(self, seen, arr: np.ndarray, pending: PendingBatch):
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        # candidate-overflow reads (rare, ~2^-16 fingerprint flukes beyond
        # max_hits true hits): exact per-window slot-plane replay
        ovr = np.nonzero(overflow)[0]
        if len(ovr):
            plane_dev = self._launch(pending.codes, "slots")
            seen = _scatter_plane_seen(seen, plane_dev)
            plane = np.asarray(plane_dev)
            for r in ovr:
                s = plane[r]
                s = s[s >= 0]
                finals[r] = fold_host(self.taxonomy, self.slot_target[s])
        return seen, finals[: pending.n_rows]

    def collect(self, seen, pending: PendingBatch):
        return self._finish_collect(seen, np.asarray(pending.packed), pending)

    def collect_many(self, seen, pendings: list):
        """Collect MANY pending batches with ONE device->host fetch.

        The finals of a group of batches are concatenated on device (one
        async dispatch) and pulled in a single np.asarray, so a group pays
        one device->host round trip.  Whether grouping pays for itself on
        the H100's local PCIe link is not measured.  Returns (seen, [finals...])
        aligned with ``pendings``, each already sliced to its n_rows.
        """
        if len(pendings) == 1:
            seen, f = self.collect(seen, pendings[0])
            return seen, [f]
        cat = jnp.concatenate([p.packed for p in pendings], axis=0)
        arr_all = np.asarray(cat)
        outs = []
        off = 0
        for p in pendings:
            n = p.packed.shape[0]
            seen, finals = self._finish_collect(seen, arr_all[off : off + n], p)
            off += n
            outs.append(finals)
        return seen, outs

    def process_batch(self, seen, batch: Batch):
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def process_long(self, seen, item: LongRead):
        """Single long read — delegates to the aggregated path."""
        seen, finals = self.process_long_many(seen, [item])
        return seen, finals[0]

    def process_long_many(self, seen, items: list):
        """Reads longer than max_len: KSIZE-1-halo chunks from MANY reads
        packed into shared planes (one dispatch per ~8192 chunks instead of
        per read).

        Lane design:

        * chunk planes are sliced with ONE vectorized gather per read (the
          per-chunk Python copy loop was the host bottleneck at ~77 chunks
          per 10 kb read);
        * the kernel is ``fp_summary_seen`` at a narrow ``LONG_HITS`` budget:
          verify + unique-k-mer scatter fused in one dispatch, and the
          summary plane crossing D2H shrinks (3 + 8 vs 3 + max_hits ints per
          chunk);
        * ALL groups are submitted before any fetch (device queues them
          back-to-back), then their summary planes come back in ONE
          concatenated device->host transfer;
        * slot->read assembly is vectorized numpy (chunk rows of a read are
          consecutive, so a masked flatten + split by per-read counts
          reconstructs every read's window-ordered hit list); only reads
          containing a candidate-overflow chunk (>LONG_HITS candidates,
          ~2^-16 flukes beyond the true hits) take the per-row replay path.
        """
        from kmer_id_tpu.io.batch import pack_codes

        l = self.max_len
        step = l - KSIZE + 1
        mh = min(LONG_HITS, self.max_hits)
        # ---- vectorized chunk planes, one gather per read
        row_item: list[int] = []  # item index of each chunk row
        plane_rows: list[np.ndarray] = []
        len_rows: list[np.ndarray] = []
        for idx, item in enumerate(items):
            codes = np.asarray(item.codes, dtype=np.uint8)
            w = len(codes) - KSIZE + 1
            if w <= 0:
                continue
            starts = np.arange(0, w, step)
            pos = starts[:, None] + np.arange(l)[None, :]
            ok = pos < len(codes)
            plane_rows.append(
                np.where(ok, codes[np.minimum(pos, len(codes) - 1)], 4)
            )
            len_rows.append(
                np.minimum(len(codes) - starts, l).astype(np.int32)
            )
            row_item.extend([idx] * len(starts))
        n_rows = len(row_item)
        if n_rows == 0:
            return seen, [0] * len(items)
        all_planes = np.concatenate(plane_rows, axis=0)
        all_lens = np.concatenate(len_rows, axis=0)
        row_item_arr = np.array(row_item, dtype=np.int64)

        # ---- pack WHOLE reads into row groups (the device per-read finals
        # kernel segments by read; a read's chunk rows must share a group)
        read_rows = np.bincount(row_item_arr, minlength=len(items))
        if read_rows.max(initial=0) > self.batch_size:
            # a read with more chunks than a whole group (>~1 Mbase at the
            # default max_len) keeps the summary-plane path
            return self._long_many_summary(
                seen, items, all_planes, all_lens, row_item_arr, l, mh
            )
        groups = []  # (row_start, n_rows, item_lo, item_hi)
        g0 = 0
        r0 = 0
        for idx in range(len(items)):
            nr = int(read_rows[idx])
            if nr == 0:
                continue
            if (r0 - g0) + nr > self.batch_size:
                groups.append((g0, r0 - g0))
                g0 = r0
            r0 += nr
        if r0 > g0:
            groups.append((g0, r0 - g0))

        # ---- submit every group, then fetch all per-read finals at once
        group_meta = []  # (row0, n, item0, n_items, finals_dev, sum_dev, args)
        for g0, n in groups:
            items_in = row_item_arr[g0 : g0 + n]
            item0 = int(items_in[0])
            k = int(items_in[-1]) - item0 + 1
            rows = 32
            while rows < n:
                rows *= 4  # pad buckets: 32/128/512/2048/8192 jit signatures
            rows = min(max(rows, 32), self.batch_size)
            plane = np.full((rows, l), 4, dtype=np.uint8)
            plane[:n] = all_planes[g0 : g0 + n]
            lengths = np.zeros(rows, dtype=np.int32)
            lengths[:n] = all_lens[g0 : g0 + n]
            seg = np.full(rows, k, dtype=np.int32)  # pads -> sentinel seg
            seg[:n] = items_in - item0
            # STATIC segment count: one jit signature per rows-bucket (a
            # per-group k+1 would recompile for every distinct read packing)
            n_segs = self.batch_size + 1
            packed, exc = pack_codes(plane, lengths)
            if packed is None:  # exception-list overflow: ship the plane
                fin_dev, sum_dev, seen = _fp_long_codes(
                    self._db, jnp.asarray(plane), jnp.asarray(lengths),
                    jnp.asarray(seg), seen, n_segs=n_segs, max_hits=mh,
                )
            else:
                fin_dev, sum_dev, seen = _fp_long_packed(
                    self._db, jnp.asarray(packed), jnp.asarray(exc),
                    jnp.asarray(lengths), jnp.asarray(seg), seen, l=l,
                    n_segs=n_segs, max_hits=mh,
                )
            group_meta.append(
                (g0, n, item0, k, fin_dev, sum_dev, (packed, exc, plane, lengths))
            )
        cat = jnp.concatenate([m[4][: m[3]] for m in group_meta], axis=0)
        F = np.asarray(cat)  # ONE fetch for every group (ints per READ)

        finals = [0] * len(items)
        off = 0
        flagged_groups = []  # (gi, flagged item offsets within group)
        for gi, (g0, n, item0, k, fin_dev, sum_dev, args) in enumerate(group_meta):
            gf = F[off : off + k]
            off += k
            for j in range(k):
                finals[item0 + j] = int(gf[j] & ~np.int32(1 << 30))
            fl = np.nonzero((gf & (1 << 30)) != 0)[0]
            if len(fl):
                flagged_groups.append((gi, fl))
        if not flagged_groups:
            return seen, finals

        # ---- flagged reads (inconsistent — COMMON for genome-scale
        # multi-target contigs — or candidate-overflow): resolve from the
        # summary planes, fetched in ONE concatenated transfer for exactly
        # the groups that need them; candidate-overflow chunks replay
        # through the exact per-window slots kernel; the ordered msca fold
        # runs BATCHED over all flagged reads (vectorized column steps)
        scat = jnp.concatenate(
            [group_meta[gi][5] for gi, _ in flagged_groups], axis=0
        )
        S_all = np.asarray(scat)
        sum_off = 0
        chunks: list[np.ndarray] = []
        flat_ids: list[int] = []
        for gi, fl in flagged_groups:
            g0, n, item0, k, fin_dev, sum_dev, args = group_meta[gi]
            S = S_all[sum_off : sum_off + sum_dev.shape[0]][:n]
            sum_off += sum_dev.shape[0]
            items_in = row_item_arr[g0 : g0 + n]
            replay = None
            ovr_rows = np.nonzero((S[:, 2] & 2) != 0)[0]
            if len(ovr_rows):
                packed, exc, plane, lengths = args
                if packed is None:
                    sl_dev = _fp_kernel_codes(
                        self._db, jnp.asarray(plane), jnp.asarray(lengths),
                        max_hits=self.max_hits, mode="slots",
                    )
                else:
                    sl_dev = _fp_kernel_packed(
                        self._db, jnp.asarray(packed), jnp.asarray(exc),
                        jnp.asarray(lengths), l=l, max_hits=self.max_hits,
                        mode="slots",
                    )
                seen = _scatter_plane_seen(seen, sl_dev)
                replay = np.asarray(sl_dev)[:n]
            # vectorized slot->read assembly over the group's flagged rows
            # (summary-lane formulation); reads containing a candidate-overflow
            # chunk rebuild row-by-row from the exact replay plane (rare)
            flag_items = item0 + fl
            ovr_items = set(
                int(items_in[int(r)]) for r in ovr_rows
            ) & set(int(x) for x in flag_items)
            mask_rows = np.isin(items_in, flag_items)
            slots = S[:, 3:]
            valid = (slots >= 0) & mask_rows[:, None]
            for r in ovr_rows:
                valid[int(r)] = False  # per-row path below
            lid = items_in - item0  # local read index per row
            flat_lid = np.repeat(lid, slots.shape[1])
            selm = valid.reshape(-1)
            fi = flat_lid[selm]
            fs = slots.reshape(-1)[selm]
            counts = np.bincount(fi, minlength=k)
            targets_all = (
                self.slot_target[fs] if len(fs) else fs.astype(np.int32)
            )
            parts_by_lid = np.split(targets_all, np.cumsum(counts)[:-1])
            for j in fl:
                idx = item0 + int(j)
                if idx in ovr_items:
                    rws = np.nonzero(items_in == idx)[0]
                    parts = []
                    for r in rws:
                        if int(r) in set(int(x) for x in ovr_rows):
                            p_ = replay[int(r)]
                            parts.append(p_[p_ >= 0])
                        else:
                            sr = slots[r]
                            parts.append(sr[sr >= 0])
                    sl = (
                        np.concatenate(parts)
                        if parts else np.zeros(0, np.int64)
                    )
                    chunks.append(self.slot_target[sl.astype(np.int64)])
                else:
                    chunks.append(parts_by_lid[int(j)])
                flat_ids.append(idx)
        from kmer_id_tpu.engine.classify import fold_host_many

        folded = fold_host_many(self.taxonomy, chunks)
        for idx, f in zip(flat_ids, folded):
            finals[idx] = int(f)
        return seen, finals

    def _long_many_summary(self, seen, items, all_planes, all_lens,
                           row_item_arr, l, mh):
        """Summary-plane lane: per-chunk (3+mh)-int summaries + host
        slot->read assembly.  Kept for reads whose chunk count exceeds a
        whole group (the per-read device kernel needs a read's rows in one
        group)."""
        from kmer_id_tpu.io.batch import pack_codes

        n_rows = len(row_item_arr)
        group_meta = []  # (start, n, summary_dev, packed_args)
        for g in range(0, n_rows, self.batch_size):
            n = min(self.batch_size, n_rows - g)
            rows = 32
            while rows < n:
                rows *= 4  # pad buckets: 32/128/512/2048/8192 jit signatures
            rows = min(max(rows, 32), self.batch_size)
            plane = np.full((rows, l), 4, dtype=np.uint8)
            plane[:n] = all_planes[g : g + n]
            lengths = np.zeros(rows, dtype=np.int32)
            lengths[:n] = all_lens[g : g + n]
            packed, exc = pack_codes(plane, lengths)
            if packed is None:  # exception-list overflow: ship the plane
                summary_dev, seen = _fp_sum_seen_codes(
                    self._db, jnp.asarray(plane), jnp.asarray(lengths),
                    seen, max_hits=mh,
                )
            else:
                summary_dev, seen = _fp_sum_seen_packed(
                    self._db, jnp.asarray(packed), jnp.asarray(exc),
                    jnp.asarray(lengths), seen, l=l, max_hits=mh,
                )
            group_meta.append((g, n, summary_dev, (packed, exc, plane, lengths)))
        cat = jnp.concatenate([m[2] for m in group_meta], axis=0)
        S = np.asarray(cat)  # ONE fetch for every group
        # rebuild the per-row view (groups were padded to bucket sizes)
        rows_list = []
        off = 0
        for g, n, sdev, _ in group_meta:
            rows_list.append(S[off : off + n])
            off += sdev.shape[0]
        S = np.concatenate(rows_list, axis=0)  # [n_rows, 3 + mh]

        # ---- overflow replay (exact per-window slots plane, per group)
        ovr_rows = np.nonzero((S[:, 2] & 2) != 0)[0]
        replay: dict[int, np.ndarray] = {}
        if len(ovr_rows):
            ovr_groups = {int(r) // self.batch_size for r in ovr_rows}
            for gi in ovr_groups:
                g, n, _, (packed, exc, plane, lengths) = group_meta[gi]
                if packed is None:
                    sl_dev = _fp_kernel_codes(
                        self._db, jnp.asarray(plane), jnp.asarray(lengths),
                        max_hits=self.max_hits, mode="slots",
                    )
                else:
                    sl_dev = _fp_kernel_packed(
                        self._db, jnp.asarray(packed), jnp.asarray(exc),
                        jnp.asarray(lengths), l=l, max_hits=self.max_hits,
                        mode="slots",
                    )
                seen = _scatter_plane_seen(seen, sl_dev)
                sl = np.asarray(sl_dev)
                for r in ovr_rows:
                    if int(r) // self.batch_size == gi:
                        replay[int(r)] = sl[int(r) - g]

        # ---- vectorized slot->read assembly (rows of a read are consecutive)
        slots = S[:, 3:]
        valid = slots >= 0
        ovr_items = set()
        for r in ovr_rows:
            valid[r] = False  # these reads take the per-row path below
            ovr_items.add(int(row_item_arr[r]))
        flat_item = np.repeat(row_item_arr, mh)
        selm = valid.reshape(-1)
        fi = flat_item[selm]
        fs = slots.reshape(-1)[selm]
        counts = np.bincount(fi, minlength=len(items))
        targets_all = self.slot_target[fs] if len(fs) else fs.astype(np.int32)
        chunks = np.split(targets_all, np.cumsum(counts)[:-1])
        for idx in ovr_items:  # rare: rebuild this read row-by-row
            rws = np.nonzero(row_item_arr == idx)[0]
            parts = []
            for r in rws:
                if int(r) in replay:
                    p = replay[int(r)]
                    p = p[p >= 0]
                else:
                    p = slots[r][slots[r] >= 0]
                parts.append(p)
            sl = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            chunks[idx] = self.slot_target[sl.astype(np.int64)]
        # batched exact fold: one vectorized msca column step per hit rank
        from kmer_id_tpu.engine.classify import fold_host_many

        return seen, fold_host_many(self.taxonomy, chunks).tolist()

    # ------------------------------------------------------------ finalize
    def ucount(self, seen) -> np.ndarray:
        if self._slot_node is None:  # one-time device pass, reused per sample
            self._slot_node = _slot_nodes(self._db["rec"], self._db["tinfo"])
        u = _ucount_device(seen, self._slot_node, num_targ=self.num_targ)
        return np.asarray(u).astype(np.int64)
