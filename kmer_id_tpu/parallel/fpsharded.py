"""Sharded fingerprint classification: data-parallel reads × bucket-range-
sharded fingerprint DB — the production multi-chip engine.

SPMD design (shard_map over a (data, db) mesh), carrying the single-chip
fingerprint layout (db/fpdb.py) onto the mesh:

* **L1 table sharded by bucket range**: db shard k owns buckets
  [k*nb1/K, (k+1)*nb1/K) of the single-choice table plus that range's
  ``rec``/``slot_target`` rows — a window's L1 bucket lives on exactly one
  shard, so candidate ownership is a partition.
* **L2 overflow cuckoo replicated, probed by db rank 0 only** (it is
  ~0.3% of keys and KBs in size; single ownership keeps hits and the
  unique-k-mer scatter exactly-once).
* **Per-shard block-Bloom gate**: shard k's filter holds exactly the keys
  k owns, so a DB too large for the single-card filter budget
  (db/fpdb.bloom_blocks_for) regains the gate once dbp shards split it;
  windows passing the gate are rank-compacted before any L1 gather,
  exactly like the flagship engine.
* **Merge = ONE all_gather of compact per-read hit planes** over ``db``:
  each shard verifies its own candidates locally (exact 60-bit key compare
  against its rec rows) and emits a NARROW [rows, 8] hit plane as (window
  pos, target, tin, tout|depth<<24) — real reads carry <= ~5 hits total and
  a shard owns ~1/dbp of them; gathering K such planes and re-sorting by
  position reconstructs the read's global hit sequence.  Shards exceeding
  the budget flag overflow and the batch replays through the exact
  per-window path.
* The consistency check / deepest-hit fast path / dynamic-trip chain msca
  fold (ops/fold.fold_targets_chain) then run identically on every db
  member from the gathered payloads (zero taxonomy gathers), keeping finals
  replicated across ``db``.
* ``seen`` stays shard-local (slot ids are local), so unique-k-mer
  accounting needs no hot-path communication.

Exactness: gcount/ucount and per-read finals are bit-identical to the
single-device fingerprint engine (tests/test_sharding.py, virtual CPU
mesh).  Candidate-overflow reads (locally or post-merge > max_hits) are
flagged and replayed through an exact per-window target-plane pass, exactly
like the single-chip engine's fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmer_id_tpu.core.codec import KSIZE
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.fpdb import FpDB, SLOTS, build_fpdb
from kmer_id_tpu.db.probes import PackedDB
from kmer_id_tpu.engine.classify import fold_host
from kmer_id_tpu.io.batch import Batch, LongRead
from kmer_id_tpu.ops.compact import compact_auto, interleave_planes
from kmer_id_tpu.ops.extract import extract_kmers
from kmer_id_tpu.ops.fold import fold_targets_chain
from kmer_id_tpu.ops.lookup import (
    _fp_bucket_match,
    bloom_hashes_jnp,
    fp_hashes_jnp,
    take_rows,
)


@dataclass
class _Pending:
    finals: object
    batch: Batch
    n_rows: int
    ovr_any: object = None  # replicated global overflow count (device scalar)


def _local_rows(garr: jax.Array) -> tuple[np.ndarray, np.ndarray]:
    """(global row indices, values) of the axis-0 shards THIS process holds
    (deduplicated — replicated axes produce repeated shards)."""
    rows: list[np.ndarray] = []
    vals: list[np.ndarray] = []
    seen_starts: set[int] = set()
    for sh in garr.addressable_shards:
        sl = sh.index[0] if sh.index else slice(0, garr.shape[0])
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else garr.shape[0]
        if start in seen_starts:
            continue
        seen_starts.add(start)
        rows.append(np.arange(start, stop))
        vals.append(np.asarray(sh.data))
    order = np.argsort([r[0] for r in rows])
    rows_a = np.concatenate([rows[i] for i in order])
    vals_a = np.concatenate([vals[i] for i in order])
    return rows_a, vals_a


def _shard_blooms(f: FpDB, dbp: int, nbloc: int) -> np.ndarray | None:
    """uint32 [dbp, nblk, 4] per-shard block-Bloom filters (see __init__).

    Every shard gets the SAME block count (the mesh kernel needs one static
    shape), sized for the fullest shard; None when even a single shard's key
    set exceeds the fast-gather-zone filter budget."""
    from kmer_id_tpu.db.fpdb import EMPTY_HI, bloom_blocks_for, build_bloom

    l2 = f.rec[f.nb * SLOTS :]
    l2occ = l2[l2[:, 0] != EMPTY_HI]
    segs = []
    for k in range(dbp):
        seg = f.rec[k * nbloc * SLOTS : (k + 1) * nbloc * SLOTS]
        occ = seg[seg[:, 0] != EMPTY_HI]
        if k == 0 and len(l2occ):
            occ = np.concatenate([occ, l2occ], axis=0)
        segs.append(occ)
    nblk = bloom_blocks_for(max(max(len(s) for s in segs), 1))
    if nblk is None:
        return None
    out = np.zeros((dbp, nblk, 4), np.uint32)
    for k, occ in enumerate(segs):
        out[k] = build_bloom(
            np.ascontiguousarray(occ[:, 0]), np.ascontiguousarray(occ[:, 1]),
            f.s4, f.s5, nblk=nblk,
        )
    return out


def _put_global(arr: np.ndarray, sharding) -> jax.Array:
    """Place a full host array onto a (possibly multi-process) sharding.

    Single-process: plain device_put.  Multi-process (every process holds
    the SAME full host array, e.g. DB tables built from the shared probe
    file): jax.make_array_from_callback hands each process only its
    addressable shards — device_put to non-addressable devices would fail.
    """
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


class ShardedFpClassifier:
    """Drop-in for engine.FpClassifier, spread over a (data, db) mesh.

    Multi-process (``jax.distributed``) capable: DB tables are placed with
    :func:`_put_global`; batches may arrive either as full host arrays
    (single-process) or as pre-sharded global jax.Arrays built from
    process-local rows (``make_global_batch``); the candidate-overflow
    replay decision is a replicated device scalar so every process takes
    the same collective branch (tests/test_multihost.py)."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        mesh: Mesh,
        batch_size: int = 1024,
        max_len: int = 512,
        max_hits: int = 32,
        fpdb: FpDB | None = None,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.mesh = mesh
        self.dp = mesh.shape["data"]
        self.dbp = mesh.shape["db"]
        if batch_size % self.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by data={self.dp}")
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_hits = max_hits
        self.taxonomy = taxonomy
        self.num_targ = db.num_targ
        self.packed_db = db
        f = fpdb if fpdb is not None else build_fpdb(db, taxonomy)
        self.fpdb = f
        if f.nb % self.dbp:
            raise ValueError(f"L1 buckets {f.nb} not divisible by db={self.dbp}")
        self.nbloc = f.nb // self.dbp
        self.loc_slots = (self.nbloc + f.nb2) * SLOTS

        # per-shard unified local tables: [dbp, nbloc*8 + nb2*8, ...] — each
        # db member's block is its L1 range followed by the full L2, so one
        # rec array serves both candidate levels locally
        recL1 = f.rec[: f.nb * SLOTS].reshape(self.dbp, self.nbloc * SLOTS, 3)
        recL2 = np.broadcast_to(
            f.rec[f.nb * SLOTS :][None], (self.dbp, f.nb2 * SLOTS, 3)
        )
        rec_loc = np.concatenate([recL1, recL2], axis=1).reshape(-1, 3)
        stL1 = f.slot_target[: f.nb * SLOTS].reshape(self.dbp, self.nbloc * SLOTS)
        stL2 = np.broadcast_to(
            f.slot_target[f.nb * SLOTS :][None], (self.dbp, f.nb2 * SLOTS)
        )
        self._st_loc_host = np.concatenate([stL1, stL2], axis=1)

        from kmer_id_tpu.db.fpdb import build_tinfo

        sh_db1 = NamedSharding(mesh, P("db", None))
        rep = NamedSharding(mesh, P())
        self._fptab = _put_global(f.fptab, sh_db1)
        self._fptab2 = _put_global(f.fptab2, rep)
        self._rec = _put_global(rec_loc, sh_db1)
        # tin -> (node, tout): tiny, replicated (db/fpdb.build_tinfo)
        self._tinfo = _put_global(build_tinfo(taxonomy), rep)
        chain3, _ = taxonomy.chain_tables()
        self._chain3 = _put_global(chain3, rep)
        # PER-SHARD block-Bloom filters: shard k's filter holds exactly the
        # keys k owns (its L1 bucket range, + every L2 key on rank 0), so a
        # DB too large for one card's filter budget (db/fpdb.bloom_blocks_for)
        # regains the bloom gate once dbp shards split it.
        import os as _os

        self._bloom = None
        if _os.environ.get("KMER_BLOOM", "1") != "0":
            blooms = _shard_blooms(f, self.dbp, self.nbloc)
            if blooms is not None:
                self._bloom = _put_global(blooms.reshape(-1, 4), sh_db1)
        self._bloom_arr = (
            self._bloom
            if self._bloom is not None
            else _put_global(np.zeros((self.dbp, 4), np.uint32), sh_db1)
        )
        self._salts = tuple(jnp.uint32(s) for s in (f.s1, f.s2, f.s3, f.s4, f.s5))
        self._data_sh = NamedSharding(mesh, P("data"))
        # seen is GLOBALLY FLAT [dp*dbp*loc], sharded jointly over both
        # mesh axes: the local block is then natively 1-D, so the in-kernel
        # scatter needs no [0,0,:] indexing or reshape
        self._seen_sh = NamedSharding(mesh, P(("data", "db")))

        nb1, nb2, nbloc, mh = f.nb, f.nb2, self.nbloc, max_hits
        sent = jnp.int32(2**31 - 1)
        # per-shard verified-hit budget: each shard contributes at most
        # ``sh`` hits to the merge (real reads carry <= ~5 hits TOTAL and a
        # shard owns ~1/dbp of them); a shard whose candidate count exceeds
        # it flags overflow and the batch replays exact.  Narrow budgets
        # shrink the compaction, the verify gather AND the dbp*sh-wide merge
        # sort.
        sh = min(8, mh)
        bloom_k = 24  # per-shard budget of filter-passing windows (each
        # shard's filter holds only ITS keys, so per-shard pass counts are
        # even lower than the single-chip engine's)
        use_bloom = self._bloom is not None
        nblk_loc = (self._bloom.shape[0] // self.dbp) if use_bloom else 1

        import os as _os2

        _stage = _os2.environ.get("KMER_SHARD_STAGE", "")  # profiling ablations

        def local_hits(fptab, fptab2, rec, tinfo, bloom, codes, lengths, salts):
            """Per-shard: bloom gate -> window compaction -> narrow candidate
            gathers -> rank compaction -> exact verify, all on local tables.
            Mirrors the single-chip engine's bloom + two-tier kernel
            (engine/fpclassify._compact_verify) shard-locally."""
            s1, s2, s3, s4, s5 = salts
            # rec/bloom local blocks arrive SLICE-FREE ([loc, 3] / [nblk, 4]
            # — the shard axis is flattened into axis 0), so no leading-axis
            # [0]-slice copies the local block
            ex = extract_kmers(codes, lengths)
            hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
            rows, p = hi.shape
            if _stage == "extract":
                z8 = jnp.zeros((rows, 8), jnp.int32)
                return (z8 + hi.sum(axis=1)[:, None].astype(jnp.int32), z8,
                        z8, z8, z8, z8 > 0, jnp.zeros((rows,), bool))
            dbi = jax.lax.axis_index("db")
            b0 = dbi.astype(jnp.int32) * nbloc
            bover = jnp.zeros((rows,), bool)
            if use_bloom:
                # gate: ONE gather into THIS shard's filter (built
                # over exactly the keys this shard owns: its L1 bucket range
                # + L2 on rank 0) decides which windows probe L1 at all
                blm = bloom
                blk, bits = bloom_hashes_jnp(hi, lo, nblk_loc, s4, s5)
                row = jnp.take(blm, blk, axis=0)
                wid = jax.lax.broadcasted_iota(jnp.uint32, row.shape, row.ndim - 1)
                need = jnp.zeros_like(row)
                for bit in bits:
                    need = need | jnp.where(
                        wid == (bit[..., None] >> 5),
                        jnp.uint32(1) << (bit[..., None] & 31), jnp.uint32(0),
                    )
                bloomed = valid & jnp.all((row & need) == need, axis=-1)
                npass = bloomed.sum(axis=1).astype(jnp.int32)
                bover = npass > bloom_k  # dropped windows: replay exact
                iota_p = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)
                wpos, _, _, (whi, wlo) = compact_auto(
                    jnp.broadcast_to(iota_p, (rows, p)), bloomed, iota_p,
                    bloom_k, extras=(hi, lo),
                )
                wvalid = wpos < sent
                wp = jnp.where(wvalid, wpos, 0)
                hi, lo, valid = whi, wlo, wvalid
                if _stage == "wcompact":
                    z8 = jnp.zeros((rows, 8), jnp.int32)
                    return (z8 + (hi.sum(axis=1) + wp.sum(axis=1).astype(
                        jnp.uint32))[:, None].astype(jnp.int32),
                            z8, z8, z8, z8, z8 > 0,
                            jnp.zeros((rows,), bool))
            else:
                wp = jax.lax.broadcasted_iota(jnp.int32, (rows, p), 1)
            b1, _, fp = fp_hashes_jnp(hi, lo, nb1, s1, s2, s3)
            inr = (b1 >= b0) & (b1 < b0 + nbloc)
            bl = jnp.clip(b1 - b0, 0, nbloc - 1)
            r1 = take_rows(fptab, bl)
            m1, i1 = _fp_bucket_match(r1, fp)
            own2 = dbi == 0
            c1, c2, _ = fp_hashes_jnp(hi, lo, nb2, s4, s5, s3)
            r2 = take_rows(fptab2, c1)
            r3 = take_rows(fptab2, c2)
            m2, i2 = _fp_bucket_match(r2, fp)
            m3, i3 = _fp_bucket_match(r3, fp)
            planes = [
                (bl * SLOTS + i1, m1 & valid & inr),
                (nbloc * SLOTS + c1 * SLOTS + i2, m2 & valid & own2),
                (nbloc * SLOTS + c2 * SLOTS + i3, m3 & valid & own2 & (c2 != c1)),
            ]
            cand_ilv, valid_ilv = interleave_planes(planes)
            pos_ilv = jnp.repeat(wp, len(planes), axis=1)
            # query key words ride as compaction payloads instead of a
            # per-row take_along_axis re-fetch (see engine/fpclassify)
            posk, cand, ncand, (qhi, qlo) = compact_auto(
                cand_ilv, valid_ilv, pos_ilv, sh,
                extras=(jnp.repeat(hi, len(planes), axis=1),
                        jnp.repeat(lo, len(planes), axis=1)),
            )
            has = posk < sent
            rrows = take_rows(rec, cand)
            ver = has & (rrows[..., 0] == qhi) & (rrows[..., 1] == qlo)
            tinw = rrows[..., 2]  # tin | depth << 24
            tin_r = (tinw & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
            info = take_rows(tinfo, tin_r)
            tgt = jnp.where(ver, info[..., 0], 0)
            tin = jnp.where(ver, tin_r, 0)
            # (tout | depth << 24) word for the merge
            tdw = (info[..., 1].astype(jnp.uint32) & jnp.uint32(0xFFFFFF)) | (
                tinw & jnp.uint32(0xFF000000)
            )
            td = jnp.where(
                ver, jax.lax.bitcast_convert_type(tdw, jnp.int32), 0
            )
            lov = (ncand > sh) | bover
            posk = jnp.where(ver, posk, sent)  # only true hits travel
            return posk, cand, tgt, tin, td, ver, lov

        def step_finals(fptab, fptab2, rec, tinfo, bloom, chain3, seen, codes,
                        lengths, salts):
            posk, cand, tgt, tin, td, ver, lov = local_hits(
                fptab, fptab2, rec, tinfo, bloom, codes, lengths, salts
            )
            rows = posk.shape[0]
            if _stage in ("local", "extract", "wcompact"):
                return seen, posk.sum(axis=1) + tgt.sum(axis=1), jax.lax.psum(
                    lov.astype(jnp.int32).sum(), "data") * 0
            # local seen scatter (slot ids are shard-local; exactly-once by
            # L1-range / L2-rank-0 ownership)
            sc = jnp.where(ver, cand, 0)
            sv = jnp.where(ver, jnp.int8(1), jnp.int8(0))
            # 1-D scatter on the flattened local block
            seen = seen.at[sc.reshape(-1)].max(
                sv.reshape(-1), mode="promise_in_bounds"
            )
            if _stage == "seen":  # profiling ablation: stop after scatter
                return seen, posk.sum(axis=1) + tgt.sum(axis=1), jax.lax.psum(
                    lov.astype(jnp.int32).sum(), "data") * 0
            # merge: gather every shard's compact hits, re-sort by window
            # pos; on a dbp=1 mesh the gather is identity and the local
            # plane is already window-ordered, so both steps drop out
            if self.dbp > 1:
                gath = jax.lax.all_gather(
                    jnp.stack([posk, tgt, tin, td], axis=-1), "db"
                )  # [dbp, rows, sh, 4]
                g = jnp.transpose(gath, (1, 0, 2, 3)).reshape(rows, -1, 4)
                gp, gt, gtin, gtd = (g[..., 0], g[..., 1], g[..., 2], g[..., 3])
                gp, gt, gtin, gtd = jax.lax.sort(
                    (gp, gt, gtin, gtd), dimension=1, num_keys=1, is_stable=True
                )
            else:
                gp, gt, gtin, gtd = posk, tgt, tin, td
            hit = gp < sent
            gtd_u = jax.lax.bitcast_convert_type(gtd, jnp.uint32)
            tout = (gtd_u & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
            depth = (gtd_u >> 24).astype(jnp.int32)
            nh = hit.sum(axis=1).astype(jnp.int32)
            dkey = jnp.where(hit, depth, -1)
            j = jnp.argmax(dkey, axis=1)
            dtin = jnp.take_along_axis(gtin, j[:, None], axis=1)[:, 0]
            dtgt = jnp.take_along_axis(gt, j[:, None], axis=1)[:, 0]
            ok = ~hit | ((gtin <= dtin[:, None]) & (dtin[:, None] <= tout))
            consistent = jnp.all(ok, axis=1)
            overflow = jax.lax.psum(lov.astype(jnp.int32), "db") > 0
            t = jnp.where(hit, gt, 0)
            need_fold = jnp.any(~consistent & (nh > 0) & ~overflow)
            t_fold = jnp.where((consistent | overflow)[:, None], 0, t)
            folded = jax.lax.cond(
                need_fold,
                lambda: fold_targets_chain(chain3, t_fold, gtin, tout),
                lambda: jnp.zeros((rows,), jnp.int32),
            )
            finals = jnp.where(consistent, jnp.where(nh > 0, dtgt, 0), folded)
            finals = jnp.where(overflow, finals | jnp.int32(1 << 30), finals)
            # replicated global overflow count: under multi-process meshes
            # every process must take the SAME replay branch (the replay is a
            # collective — divergent host control flow would deadlock), so
            # the trigger rides out of the kernel replicated instead of being
            # derived from process-local finals rows
            ovr_any = jax.lax.psum(overflow.astype(jnp.int32).sum(), "data")
            return seen, finals, ovr_any

        def step_targets(fptab, fptab2, rec, tinfo, bloom, chain3, seen, codes,
                         lengths, salts):
            """Exact per-window global target plane (replay/long-read path).
            Probes every window (no bloom gate: this path must be exact even
            for windows a budget dropped)."""
            s1, s2, s3, s4, s5 = salts
            ex = extract_kmers(codes, lengths)
            hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
            dbi = jax.lax.axis_index("db")
            b0 = dbi.astype(jnp.int32) * nbloc
            b1, _, fp = fp_hashes_jnp(hi, lo, nb1, s1, s2, s3)
            inr = (b1 >= b0) & (b1 < b0 + nbloc)
            bl = jnp.clip(b1 - b0, 0, nbloc - 1)
            own2 = dbi == 0
            c1, c2, _ = fp_hashes_jnp(hi, lo, nb2, s4, s5, s3)
            m1, i1 = _fp_bucket_match(jnp.take(fptab, bl, axis=0), fp)
            m2, i2 = _fp_bucket_match(jnp.take(fptab2, c1, axis=0), fp)
            m3, i3 = _fp_bucket_match(jnp.take(fptab2, c2, axis=0), fp)
            planes = [
                (bl * SLOTS + i1, m1 & valid & inr),
                (nbloc * SLOTS + c1 * SLOTS + i2, m2 & valid & own2),
                (nbloc * SLOTS + c2 * SLOTS + i3, m3 & valid & own2 & (c2 != c1)),
            ]
            slot = jnp.full_like(hi, -1, dtype=jnp.int32)
            stin = jnp.zeros_like(hi, dtype=jnp.int32)
            for cnd, cv in planes:
                rws = jnp.take(rec, cnd.reshape(-1), axis=0).reshape(*cnd.shape, 3)
                vr = cv & (rws[..., 0] == hi) & (rws[..., 1] == lo)
                slot = jnp.where(vr, cnd, slot)
                stin = jnp.where(
                    vr, (rws[..., 2] & jnp.uint32(0xFFFFFF)).astype(jnp.int32), stin
                )
            sc = jnp.where(slot >= 0, slot, 0)
            sv = jnp.where(slot >= 0, jnp.int8(1), jnp.int8(0))
            seen = seen.at[sc.reshape(-1)].max(
                sv.reshape(-1), mode="promise_in_bounds"
            )
            # 1-D gather of the node column
            tloc = jnp.where(
                slot >= 0,
                jnp.take(tinfo[:, 0], stin.reshape(-1), axis=0).reshape(slot.shape),
                0,
            )
            return seen, jax.lax.psum(tloc, "db")

        ispec = (
            P("db", None), P(None, None), P("db", None),  # fptab, fptab2, rec
            P(None, None),  # tinfo (replicated)
            P("db", None),  # per-shard bloom filters (shard axis flattened)
            P(None, None, None),  # chain3
            P(("data", "db")),  # seen (globally flat, jointly sharded)
            P("data", None), P("data"),  # codes, lengths
            (P(), P(), P(), P(), P()),  # salts
        )

        def build(fn, out):
            f_ = shard_map(
                fn, mesh=mesh, in_specs=ispec,
                out_specs=(P(("data", "db")),) + out, check_vma=False,
            )
            return jax.jit(f_, donate_argnums=(6,))

        self._step_finals = build(step_finals, (P("data"), P()))
        self._step_targets = build(step_targets, (P("data", None),))

        num_targ = self.num_targ
        from kmer_id_tpu.db.fpdb import EMPTY_HI

        def ucount_dev(rec, tinfo, seen):
            """In-mesh unique-k-mer finalize: union the per-data seen bitmaps
            with a psum, resolve each local slot's target from its rec row's
            tin label, segment-sum per target, psum over db.  Device->host
            traffic shrinks from the whole [dp*dbp*loc] bitmap (GBs at
            production slot counts) to ONE replicated [num_targ] int32
            vector (~24 KB)."""
            from kmer_id_tpu.engine.fpclassify import target_histogram

            s = jax.lax.psum(seen.astype(jnp.int32), "data")
            tin = (rec[:, 2] & jnp.uint32(0xFFFFFF)).astype(jnp.int32)
            # 1-D gather of the node column
            t = jnp.take(tinfo[:, 0], tin, axis=0)
            m = (s > 0) & (rec[:, 0] != EMPTY_HI) & (t > 1)
            u = target_histogram(m, t, num_targ)
            # L2 rows are replicated on every db member but only rank 0 ever
            # scatters them (own2 gating in local_hits), so the db-psum
            # counts each slot exactly once
            return jax.lax.psum(u, "db")

        self._ucount_dev = jax.jit(
            shard_map(
                ucount_dev, mesh=mesh,
                in_specs=(
                    P("db", None), P(None, None), P(("data", "db"))
                ),
                out_specs=P(), check_vma=False,
            )
        )

    # ------------------------------------------------------------ API
    def new_seen(self) -> jax.Array:
        shape = (self.dp * self.dbp * self.loc_slots,)
        if jax.process_count() == 1:
            return jax.device_put(jnp.zeros(shape, jnp.int8), self._seen_sh)
        return jax.make_array_from_callback(
            shape, self._seen_sh,
            lambda idx: np.zeros(np.zeros(shape, np.int8)[idx].shape, np.int8),
        )

    def local_data_rows(self) -> np.ndarray:
        """Global batch rows whose data shards THIS process holds, ascending.

        The multi-process driver slices its decoded [B, L] plane to these
        rows before :meth:`make_global_batch` (every process decodes the
        whole stream — cheap next to classification — and classifies only
        its slice)."""
        shape = (self.batch_size, self.max_len)
        rows: list[np.ndarray] = []
        starts: set[int] = set()
        for d, idx in self._data_sh.devices_indices_map(shape).items():
            if d.process_index != jax.process_index():
                continue
            sl = idx[0]
            start = sl.start or 0
            if start in starts:
                continue  # replicated db axis: same data rows
            starts.add(start)
            stop = sl.stop if sl.stop is not None else self.batch_size
            rows.append(np.arange(start, stop))
        return np.sort(np.concatenate(rows))

    def collect_global(self, seen, pending: _Pending):
        """Multi-process collect that returns the FULL finals vector on
        every process (one small host all-gather per batch), so the driver's
        read-order accounting — gcount, first-SAVENUM read capture — runs
        identically everywhere and process 0 can write the reference-format
        outputs.  Single-process calls fall through to :meth:`collect`."""
        if jax.process_count() == 1:
            return self.collect(seen, pending)
        from jax.experimental import multihost_utils as mhu

        rows, arr = _local_rows(pending.finals)
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        if int(pending.ovr_any) > 0:
            seen, tgt_g = self._call(
                self._step_targets, seen, pending.batch.codes,
                pending.batch.lengths,
            )
            trows, tgt = _local_rows(tgt_g)
            by_row = {int(r): tgt[i] for i, r in enumerate(trows)}
            for i in np.nonzero(overflow)[0]:
                t = by_row[int(rows[i])]
                finals[i] = fold_host(self.taxonomy, t[t > 0])
        gr = np.asarray(mhu.process_allgather(rows)).reshape(-1)
        gf = np.asarray(mhu.process_allgather(finals)).reshape(-1)
        out = np.zeros(self.batch_size, dtype=np.int32)
        out[gr] = gf
        return seen, out[: pending.n_rows]

    def make_global_batch(self, local_codes, local_lengths):
        """Process-local batch rows -> global P("data")-sharded arrays.

        Each process passes the rows for ITS slice of the data axis (global
        batch row r lives on data shard r * dp // batch_size); the returned
        arrays feed submit_batch/_call directly.
        """
        from jax import make_array_from_process_local_data as mk

        codes = mk(self._data_sh, np.ascontiguousarray(local_codes))
        lengths = mk(self._data_sh, np.ascontiguousarray(local_lengths))
        return codes, lengths

    def _put_data(self, x):
        if isinstance(x, jax.Array) and x.sharding == self._data_sh:
            return x  # pre-sharded global array (multi-process feeders)
        return jax.device_put(jnp.asarray(x), self._data_sh)

    def _call(self, fn, seen, codes, lengths):
        return fn(
            self._fptab, self._fptab2, self._rec, self._tinfo,
            self._bloom_arr, self._chain3, seen,
            self._put_data(codes), self._put_data(lengths), self._salts,
        )

    def submit_batch(self, seen, batch: Batch):
        seen, finals, ovr_any = self._call(
            self._step_finals, seen, batch.codes, batch.lengths
        )
        return seen, _Pending(finals, batch, batch.n_rows, ovr_any)

    def collect(self, seen, pending: _Pending):
        """Single-process collect (full finals visible).  Multi-process
        drivers use :meth:`collect_local`."""
        arr = np.asarray(pending.finals)
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        if int(pending.ovr_any) > 0:
            seen, tgt = self._call(
                self._step_targets, seen, pending.batch.codes, pending.batch.lengths
            )
            tgt = np.asarray(tgt)
            for r in np.nonzero(overflow)[0]:
                finals[r] = fold_host(self.taxonomy, tgt[r][tgt[r] > 0])
        return seen, finals[: pending.n_rows]

    def collect_local(self, seen, pending: _Pending):
        """Multi-process collect: returns (global_row_indices, finals) for
        THIS process's addressable rows only.  The replay branch keys off
        the replicated overflow count, so all processes run the collective
        together even when only one holds an overflowing row."""
        rows, arr = _local_rows(pending.finals)
        overflow = (arr & (1 << 30)) != 0
        finals = (arr & ~np.int32(1 << 30)).astype(np.int32)
        if int(pending.ovr_any) > 0:
            seen, tgt_g = self._call(
                self._step_targets, seen, pending.batch.codes, pending.batch.lengths
            )
            trows, tgt = _local_rows(tgt_g)
            by_row = {int(r): tgt[i] for i, r in enumerate(trows)}
            for i in np.nonzero(overflow)[0]:
                t = by_row[int(rows[i])]
                finals[i] = fold_host(self.taxonomy, t[t > 0])
        keep = rows < pending.n_rows
        return seen, rows[keep], finals[keep]

    def process_batch(self, seen, batch: Batch):
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def process_long(self, seen, item: LongRead):
        seen, finals = self.process_long_many(seen, [item])
        return seen, finals[0]

    def process_long_many(self, seen, items: list):
        """KSIZE-1-halo chunks from MANY reads packed into shared mesh
        planes — one dispatch per ~batch_size chunks instead of per read
        (the single-chip engine's aggregated long lane, carried onto the
        mesh; a per-read loop here regressed FASTA workloads to one mesh
        roundtrip per read).  Uses the exact per-window target-plane step,
        so the ordered fold sees every window and the shard-local seen
        scatter happens inside the same dispatch."""
        l = self.max_len
        step = l - KSIZE + 1
        specs = []  # (item_idx, start, n_windows_owned)
        for idx, item in enumerate(items):
            w = len(item.codes) - KSIZE + 1
            for s in range(0, max(w, 0), step):
                specs.append((idx, s, min(step, w - s)))
        parts: dict[int, list[np.ndarray]] = {i: [] for i in range(len(items))}
        for g in range(0, len(specs), self.batch_size):
            group = specs[g : g + self.batch_size]
            plane = np.full((self.batch_size, l), 4, dtype=np.uint8)
            lengths = np.zeros(self.batch_size, dtype=np.int32)
            for r, (idx, s, _) in enumerate(group):
                chunk = items[idx].codes[s : s + l]
                plane[r, : len(chunk)] = chunk
                lengths[r] = len(chunk)
            seen, tgt = self._call(self._step_targets, seen, plane, lengths)
            tgt = np.asarray(tgt)
            for r, (idx, s, owned) in enumerate(group):
                parts[idx].append(tgt[r, :owned])
        from kmer_id_tpu.engine.classify import fold_host_many

        seqs = []
        for idx in range(len(items)):
            targets = (
                np.concatenate(parts[idx]) if parts[idx] else np.zeros(0, np.int32)
            )
            seqs.append(targets[targets > 0])
        return seen, fold_host_many(self.taxonomy, seqs).tolist()

    def ucount(self, seen) -> np.ndarray:
        """Per-target unique-k-mer counts, computed IN the mesh (see
        ``ucount_dev``); only the replicated [num_targ] vector crosses
        device->host, on every process."""
        if isinstance(seen, jax.Array):
            # any device bitmap takes the in-mesh path — sharding-equality
            # checks are too brittle (jnp.maximum of two P("data","db")
            # arrays can come back with an equivalent-but-unequal sharding
            # object, and under jax.distributed the host fallback below
            # cannot even fetch the global array)
            return np.asarray(self._ucount_dev(
                self._rec, self._tinfo, seen
            )).astype(np.int64)
        # host-array fallback (tests hand in raw bitmaps, flat or 3-D)
        s = np.asarray(seen).reshape(self.dp, self.dbp, self.loc_slots)
        merged = s.any(axis=0)  # [dbp, loc_slots]
        t = self._st_loc_host[merged]
        t = t[t > 1]
        return np.bincount(t, minlength=self.num_targ).astype(np.int64)
