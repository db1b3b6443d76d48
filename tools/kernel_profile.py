#!/usr/bin/env python
"""Stage-level device-kernel profiling on the card (bench-scale DB).

Every timing is an IN-JIT fori_loop over ITERS iterations with row-rolled
(salted) inputs so XLA cannot hoist the body, and ends in
block_until_ready.  Both jit signatures are compiled before any timing.

Usage:  python tools/kernel_profile.py [--iters 20] [--stages ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")

B, L = 8192, 160
ITERS = 20


def log(m):
    print(f"[kprof] {m}", file=sys.stderr, flush=True)


def load_engine():
    from kmer_id_tpu.config import ClassifyConfig
    from kmer_id_tpu.engine.pipeline import load_db, make_classifier

    wdir = os.path.join(CACHE, "bench10")
    db = load_db(
        os.path.join(wdir, "bench10_data.txt"),
        os.path.join(wdir, "bench10_tree.txt"),
        os.path.join(wdir, "bench10_probes.txt.gz"),
        num_targ=5982,
        cache_dir=os.path.join(CACHE, "packed_full"),
    )
    cfg = ClassifyConfig.preset("vf6", batch_size=B, max_len=L)
    clf = make_classifier(db, cfg, cache_dir=os.path.join(CACHE, "packed_full"))
    return db, clf


def make_codes(db, clf, mixed_frac: float):
    """[B, L] uint8 code planes: reads with 1-3 planted probes of one target;
    a mixed_frac tail plants 2 probes of random (incomparable) targets."""
    rng = np.random.default_rng(7)
    packed = db.packed
    n = min(len(packed), 100_000)
    keys = (packed.hi[:n].astype(np.uint64) << np.uint64(32)) | packed.lo[:n]
    shifts = np.array([2 * (29 - j) for j in range(30)], dtype=np.uint64)
    pcm = ((keys[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    targets = packed.target[:n]
    order = np.argsort(targets, kind="stable")
    ts = targets[order]
    tvals, tstart, tcount = np.unique(ts, return_index=True, return_counts=True)
    ok = tcount >= 3
    tvals, tstart, tcount = tvals[ok], tstart[ok], tcount[ok]

    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    nmix = int(B * mixed_frac)
    ci = np.arange(B - nmix)
    tsel = rng.integers(0, len(tvals), size=len(ci))
    nplant = rng.integers(1, 4, size=len(ci))
    for j in range(3):
        m = nplant > j
        rows = ci[m]
        pidx = order[tstart[tsel[m]] + rng.integers(0, 1 << 31, size=len(rows)) % tcount[tsel[m]]]
        pos = rng.integers(0, L - 30, size=len(rows))
        idx = pos[:, None] + np.arange(30)[None, :]
        codes[rows[:, None], idx] = pcm[pidx]
    mi = np.arange(B - nmix, B)
    for j in range(2):
        pidx = rng.integers(0, len(pcm), size=len(mi))
        pos = rng.integers(0, L - 30, size=len(mi))
        idx = pos[:, None] + np.arange(30)[None, :]
        codes[mi[:, None], idx] = pcm[pidx]
    lengths = np.full(B, L, dtype=np.int32)
    return codes, lengths


def timed(name, build_fn, iters=ITERS):
    """build_fn() -> jitted callable f(i) whose output is a scalar; times
    an in-jit loop of f over rolled inputs."""
    import jax
    import jax.numpy as jnp

    f = build_fn()
    # compile + one warm pass
    f(iters).block_until_ready()
    t0 = time.time()
    f(iters).block_until_ready()
    dt = (time.time() - t0) / iters * 1000
    log(f"{name:44s} {dt:8.2f} ms/batch")
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--mixed", type=float, default=0.1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from kmer_id_tpu.engine import fpclassify as F
    from kmer_id_tpu.ops.extract import extract_kmers
    from kmer_id_tpu.ops.lookup import fp_candidates

    db, clf = load_engine()
    dbd = clf._db
    results = {}

    for label, frac in (("consistent", 0.0), ("mixed", args.mixed)):
        codes_np, lengths_np = make_codes(db, clf, frac)
        codes = jnp.asarray(codes_np)
        lengths = jnp.asarray(lengths_np)
        log(f"--- fixture: {label} ({frac:.0%} incomparable 2-target reads)")

        def loop(body):
            """fori_loop wrapper: body(dbd, codes_i) -> scalar contribution.
            The DB dict rides as a jit ARGUMENT — closing over device arrays
            would embed GBs of tables in the program as constants."""
            def build():
                @jax.jit
                def run(d, cds, iters):
                    def step(i, acc):
                        c = jnp.roll(cds, i, axis=0)
                        return acc + body(d, c)
                    return jax.lax.fori_loop(0, iters, step, jnp.int32(0))
                return lambda iters: run(dbd, codes, iters)
            return build

        def ex_only(d, c):
            ex = extract_kmers(c, lengths)
            return ex["hi"].sum().astype(jnp.int32)

        def cand(d, c):
            ex = extract_kmers(c, lengths)
            planes = fp_candidates(d, ex["hi"], ex["lo"], ex["valid"])
            return sum(p[0].sum() for p in planes).astype(jnp.int32)

        def compact_verify(d, c):
            ex = extract_kmers(c, lengths)
            cv = F._compact_verify(d, ex, clf.max_hits)
            return cv["nh"].sum() + cv["deepest"].sum()

        def finals_noseen(d, c):
            """fp_finals minus the seen scatter (mirrors the CURRENT
            implementation: dynamic-trip chain fold, consistent rows
            zeroed)."""
            ex = extract_kmers(c, lengths)
            cv = F._compact_verify(d, ex, clf.max_hits)
            from kmer_id_tpu.ops.fold import fold_targets_chain
            b = ex["hi"].shape[0]
            t = cv["t"]
            dtgt = cv["dtgt"]
            need_fold = jnp.any(~cv["consistent"] & (cv["nh"] > 0))
            t_fold = jnp.where(cv["consistent"][:, None], 0, t)
            folded = jax.lax.cond(
                need_fold,
                lambda: fold_targets_chain(d["chain3"], t_fold, cv["tin"], cv["tout"]),
                lambda: jnp.zeros((b,), jnp.int32),
            )
            finals = jnp.where(cv["consistent"], jnp.where(cv["nh"] > 0, dtgt, 0), folded)
            return finals.sum()

        def full(d, c):
            seen = jnp.zeros((clf.fpdb.n_slots,), jnp.int8)
            finals, seen = F.fp_finals(d, extract_kmers(c, lengths), seen, clf.max_hits)
            return finals.sum() + seen[0].astype(jnp.int32)

        # ---- experiments: candidate-stage and compaction alternatives
        from kmer_id_tpu.ops.lookup import fp_hashes_jnp, _fp_bucket_match

        def cand_l2mask(d, c):
            """L2 gathers with indices collapsed to bucket 0 for windows that
            provably cannot be in L2 (L1 bucket not full and no fp match) —
            tests whether same-index gathers are cheaper."""
            ex = extract_kmers(c, lengths)
            q_hi, q_lo, valid = ex["hi"], ex["lo"], ex["valid"]
            fptab, fptab2 = d["fptab"], d["fptab2"]
            nb1, nb2 = fptab.shape[0], fptab2.shape[0]
            b1, _, fp = fp_hashes_jnp(q_hi, q_lo, nb1, d["fp_s1"], d["fp_s2"], d["fp_s3"])
            c1, c2, _ = fp_hashes_jnp(q_hi, q_lo, nb2, d["fp_s4"], d["fp_s5"], d["fp_s3"])
            r1 = jnp.take(fptab, b1, axis=0)
            m1, s1 = _fp_bucket_match(r1, fp)
            lo16 = r1 & jnp.uint32(0xFFFF)
            hi16 = r1 >> 16
            full1 = jnp.all(lo16 != 0, axis=-1) & jnp.all(hi16 != 0, axis=-1)
            need2 = valid & (m1 | full1)
            c1m = jnp.where(need2, c1, 0)
            c2m = jnp.where(need2, c2, 0)
            r2 = jnp.take(fptab2, c1m, axis=0)
            r3 = jnp.take(fptab2, c2m, axis=0)
            m2, s2 = _fp_bucket_match(r2, fp)
            m3, s3 = _fp_bucket_match(r3, fp)
            off = jnp.int32(nb1 * 8)
            return (
                (b1 * 8 + s1).sum() + (off + c1m * 8 + s2).sum()
                + ((m2 & need2).sum() + (m3 & need2 & (c2 != c1)).sum()).astype(jnp.int32)
            ).astype(jnp.int32)

        def compact_topk(d, c):
            ex = extract_kmers(c, lengths)
            q_hi, q_lo, valid = ex["hi"], ex["lo"], ex["valid"]
            planes = fp_candidates(d, q_hi, q_lo, valid)
            bb, pp = q_hi.shape
            pos = jax.lax.broadcasted_iota(jnp.int32, (bb, pp), 1)
            sent = jnp.int32(2**31 - 1)
            keys = jnp.concatenate([jnp.where(v, pos, sent) for _, v in planes], axis=1)
            payload = jnp.concatenate([cc for cc, _ in planes], axis=1)
            negv, idx = jax.lax.top_k(-keys, clf.max_hits)
            cand32 = jnp.take_along_axis(payload, idx, axis=1)
            return cand32.sum() + (-negv).sum()

        # ---- compaction formulations in context (ops/compact.py)
        from kmer_id_tpu.ops import compact as OC

        def _cv_with(impl_fn, mh):
            def f(d, c):
                ex = extract_kmers(c, lengths)
                hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
                planes = fp_candidates(d, hi, lo, valid)
                cand_ilv, valid_ilv = OC.interleave_planes(planes)
                posi = jax.lax.broadcasted_iota(
                    jnp.int32, (1, cand_ilv.shape[1]), 1
                ) // len(planes)
                pos32, cand32, ncand, (qhi, qlo) = impl_fn(
                    cand_ilv, valid_ilv, posi, mh,
                    extras=(jnp.repeat(hi, len(planes), axis=1),
                            jnp.repeat(lo, len(planes), axis=1)),
                )
                bb, pp = hi.shape
                has = pos32 < jnp.int32(2**31 - 1)
                rows = jnp.take(d["rec"], cand32.reshape(-1), axis=0).reshape(bb, mh, 3)
                ver = has & (rows[..., 0] == qhi) & (rows[..., 1] == qlo)
                return ver.sum().astype(jnp.int32) + ncand.sum()
            return f

        for mh in (clf.max_hits, 8):
            for nm, fn in (
                ("sort", OC.compact_sort),
                ("reduce", OC.compact_ranks),
            ):
                results[f"{label}/+cv_{nm}_mh{mh}"] = timed(
                    f"+ compact[{nm}] mh={mh} + verify",
                    loop(_cv_with(fn, mh)), args.iters,
                )

        # ---- bloom-path stage decomposition (the production pipeline)
        from kmer_id_tpu.ops.lookup import bloom_pass
        from kmer_id_tpu.ops.compact import compact_auto as CA

        def bloom_only(d, c):
            ex = extract_kmers(c, lengths)
            bl = bloom_pass(d, ex["hi"], ex["lo"], ex["valid"])
            return bl.sum().astype(jnp.int32)

        def bloom_c1(d, c):
            ex = extract_kmers(c, lengths)
            hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
            bl = bloom_pass(d, hi, lo, valid)
            bb, pp = hi.shape
            iota_p = jax.lax.broadcasted_iota(jnp.int32, (1, pp), 1)
            wpos, _, _, (whi, wlo) = CA(
                jnp.broadcast_to(iota_p, (bb, pp)), bl, iota_p, F.BLOOM_K,
                extras=(hi, lo),
            )
            return wpos.sum() + whi.sum().astype(jnp.int32)

        def bloom_cand(d, c):
            ex = extract_kmers(c, lengths)
            hi, lo, valid = ex["hi"], ex["lo"], ex["valid"]
            bl = bloom_pass(d, hi, lo, valid)
            bb, pp = hi.shape
            iota_p = jax.lax.broadcasted_iota(jnp.int32, (1, pp), 1)
            wpos, _, _, (whi, wlo) = CA(
                jnp.broadcast_to(iota_p, (bb, pp)), bl, iota_p, F.BLOOM_K,
                extras=(hi, lo),
            )
            wvalid = wpos < jnp.int32(2**31 - 1)
            planes = fp_candidates(d, whi, wlo, wvalid)
            return sum(p[0].sum() for p in planes).astype(jnp.int32)

        if "bloom" in dbd:
            results[f"{label}/bloom"] = timed(
                "bloom gather+test", loop(bloom_only), args.iters)
            results[f"{label}/bloom_c1"] = timed(
                "+ window compaction (BLOOM_K)", loop(bloom_c1), args.iters)
            results[f"{label}/bloom_cand"] = timed(
                "+ narrow L1/L2 candidates", loop(bloom_cand), args.iters)

        results[f"{label}/extract"] = timed("extract", loop(ex_only), args.iters)
        results[f"{label}/+candidates"] = timed("+ fp candidates (L1+L2 gathers)", loop(cand), args.iters)
        results[f"{label}/+cand_l2mask"] = timed("+ candidates, L2 indices masked", loop(cand_l2mask), args.iters)
        results[f"{label}/+compact_topk"] = timed("+ compact via top_k", loop(compact_topk), args.iters)
        results[f"{label}/+compact_verify"] = timed("+ compact + verify", loop(compact_verify), args.iters)
        results[f"{label}/+fold"] = timed("+ target map + fold", loop(finals_noseen), args.iters)
        results[f"{label}/full"] = timed("full finals (with seen scatter)", loop(full), args.iters)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
