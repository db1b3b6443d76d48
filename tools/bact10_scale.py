#!/usr/bin/env python
"""Prove real-bact10 scale: build + load + classify against a ~1e8-probe DB.

The reference's production bact10 DB is ~1.5 GB of gzipped probe text
(README.md:12) at a 2^30-cell table (newkmer_10nx.cpp:49); at the builder's
fixed-width line format that is ~1e8 probes.  This tool builds the fpdb at
that scale, reports its build/load times and device-table footprint, and
measures classify throughput on one card.  Results are printed as JSON and
written to .bench_cache/bact10_scale/scale_report.json.

Usage: python tools/bact10_scale.py [--probes 100000000] [--reads 200000]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache", "bact10_scale")
REF = "/root/reference"


def log(m):
    print(f"[scale] {m}", file=sys.stderr, flush=True)


def gen_fixture(n_probes: int, n_reads: int, read_len: int = 150):
    """1e8 random canonical probes over the real b10 taxonomy + planted reads.
    Writes the probe text gz (the reference's on-disk format) so the text
    parse is part of the measured first-load cost, like production."""
    sys.path.insert(0, ROOT)
    import bench as B

    os.makedirs(CACHE, exist_ok=True)
    meta_path = os.path.join(CACHE, "meta.json")
    if os.path.exists(meta_path):
        return json.load(open(meta_path))
    rng = np.random.default_rng(20260820)
    wdir = os.path.join(CACHE, "db")
    os.makedirs(wdir, exist_ok=True)
    data_txt = open(os.path.join(REF, "b10", "bData10.txt")).read()
    tree_txt = open(os.path.join(REF, "b10", "btree_10.txt")).read()
    open(os.path.join(wdir, "s_data.txt"), "w").write(data_txt)
    open(os.path.join(wdir, "s_tree.txt"), "w").write(tree_txt)
    targs_pool = np.array(
        sorted({int(l.split()[0]) for l in data_txt.splitlines() if l.strip()}),
        dtype=np.int32,
    )
    targs_pool = targs_pool[targs_pool > 1]

    log(f"mining {n_probes / 1e6:.0f}M unique canonical keys...")
    t0 = time.time()
    chunks = []
    total = 0
    while total < n_probes:
        raw = rng.integers(0, 1 << 60, size=30_000_000, dtype=np.uint64)
        canon = np.minimum(raw, B._revcomp_vec(raw))
        chunks.append(canon)
        total += len(canon)
    keys = np.unique(np.concatenate(chunks))[:n_probes]
    del chunks
    rng.shuffle(keys)
    targets = targs_pool[rng.integers(0, len(targs_pool), size=len(keys))]
    log(f"  keys ready in {time.time() - t0:.0f}s; writing probe text...")
    t0 = time.time()
    with gzip.open(os.path.join(wdir, "s_probes.txt.gz"), "wb", compresslevel=1) as f:
        CH = 2_000_000
        for s in range(0, len(keys), CH):
            ke = keys[s : s + CH]
            te = targets[s : s + CH]
            n = len(ke)
            lines = np.zeros((n, 44), dtype=np.uint8)
            lines[:, :30] = B._keys_to_char_matrix(ke)
            lines[:, 30] = ord(",")
            d = te.astype(np.int64)
            for col, div in ((31, 1000), (32, 100), (33, 10), (34, 1)):
                lines[:, col] = ord("0") + (d // div) % 10
            lines[:, 35:44] = np.frombuffer(b",0,0,F,3\n", dtype=np.uint8)
            f.write(lines.tobytes())
    gz_bytes = os.path.getsize(os.path.join(wdir, "s_probes.txt.gz"))
    log(f"  probes written in {time.time() - t0:.0f}s ({gz_bytes / 1e9:.2f} GB gz)")

    # reads planting probes (60% consistent single-target profile)
    base_chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = base_chars[rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)]
    pcm = B._keys_to_char_matrix(keys[:100_000])
    sel = rng.random(n_reads) < 0.7
    rows = np.nonzero(sel)[0]
    pidx = rng.integers(0, len(pcm), size=len(rows))
    pos = rng.integers(0, read_len - 30, size=len(rows))
    idx = pos[:, None] + np.arange(30)[None, :]
    reads[rows[:, None], idx] = pcm[pidx]
    with gzip.open(os.path.join(CACHE, "reads.fastq.gz"), "wb", compresslevel=1) as f:
        for s in range(0, n_reads, 100_000):
            n = min(100_000, n_reads - s)
            rec = []
            for i in range(n):
                rec.append(b"@r%07d\n" % (s + i))
                rec.append(reads[s + i].tobytes())
                rec.append(b"\n+\n")
                rec.append(b"J" * read_len + b"\n")
            f.write(b"".join(rec))
    meta = {
        "wdir": wdir, "n_probes": int(len(keys)), "gz_bytes": int(gz_bytes),
        "reads": os.path.join(CACHE, "reads.fastq.gz"), "n_reads": int(n_reads),
    }
    json.dump(meta, open(meta_path, "w"))
    return meta


def _reference_baseline_1e8(meta) -> dict:
    """Reference reads/sec against the SAME 1e8-probe DB, unmodified binary
    at its production table size (2^30 cells, 24 GiB) — the denominator at
    this scale.

    bench.py's methodology: ONE process loads the DB once (the ~25 min text
    parse + 24 GiB memset is excluded), then runs a tiny job + the 200k-read
    job 5x; per-pass classify time = mtime deltas between consecutive job
    results.  Median + spread cached in baseline_1e8.json."""
    import subprocess

    bl_path = os.path.join(CACHE, "baseline_1e8.json")
    if os.path.exists(bl_path):
        return json.load(open(bl_path))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden_harness as gh

    binary = gh._compile("kmer_read_vf6.cpp", "ref_read_vf6_bench_full", [])
    if binary is None:
        return {}
    workdir = os.path.join(CACHE, "refrun")
    jdir = os.path.join(workdir, "jobs")
    os.makedirs(jdir, exist_ok=True)
    os.makedirs(os.path.join(workdir, "s"), exist_ok=True)
    for f in os.listdir(meta["wdir"]):
        src = os.path.join(meta["wdir"], f)
        dst = os.path.join(workdir, "s", f)
        if not os.path.exists(dst):
            os.link(src, dst)
    tiny = os.path.join(CACHE, "reads_tiny.fastq.gz")
    if not os.path.exists(tiny):
        with gzip.open(meta["reads"], "rb") as fi, gzip.open(tiny, "wb") as fo:
            for _ in range(400):
                fo.write(fi.readline())
    n_full = 5
    open(os.path.join(jdir, "jobs.txt"), "w").write(
        f"tiny 1\n{tiny}\n"
        + "".join(f"full{i} 1\n{meta['reads']}\n" for i in range(n_full))
    )
    log("timing reference at 1e8 probes (ONE process: ~25 min DB load + "
        f"tiny + {n_full} x {meta['n_reads']}-read jobs)...")
    t0 = time.time()
    r = subprocess.run(
        [binary, "-name", "s", "-jname", "jobs"],
        cwd=workdir, capture_output=True, text=True, timeout=14400,
    )
    assert r.returncode == 0, r.stdout[-500:] + r.stderr[-500:]
    wall = time.time() - t0
    marks = [os.path.getmtime(os.path.join(jdir, "tiny_result.txt"))] + [
        os.path.getmtime(os.path.join(jdir, f"full{i}_result.txt"))
        for i in range(n_full)
    ]
    runs = sorted(
        round(meta["n_reads"] / max(b - a, 1e-3), 1)
        for a, b in zip(marks, marks[1:])
    )
    bl = {
        "reads_per_sec": float(np.median(runs)),
        "runs": runs,
        "load_s": round(marks[0] - t0, 1),
        "wall_s": round(wall, 1),
    }
    json.dump(bl, open(bl_path, "w"))
    log(f"reference 1e8 baseline: median {bl['reads_per_sec']:,.0f} reads/s "
        f"of {runs} (DB load {bl['load_s']:.0f}s)")
    return bl


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probes", type=int, default=100_000_000)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--repeat-file", type=int, default=1,
                    help="feed the read file N times per run so per-sample "
                         "fixed costs (269M-slot seen alloc + ucount "
                         "finalize) amortize like a production-size sample")
    ap.add_argument("--ref-baseline", action="store_true",
                    help="measure the unmodified-reference baseline at this "
                         "scale (one ~30 min single-core run; cached)")
    args = ap.parse_args()

    meta = gen_fixture(args.probes, args.reads)
    if args.ref_baseline:
        bl = _reference_baseline_1e8(meta)
        rp = os.path.join(CACHE, "scale_report.json")
        if os.path.exists(rp) and bl:
            rep = json.load(open(rp))
            rep["baseline_reads_per_sec"] = bl["reads_per_sec"]
            rep["baseline_runs"] = bl["runs"]
            if rep.get("reads_per_sec"):
                rep["vs_baseline"] = round(
                    rep["reads_per_sec"] / bl["reads_per_sec"], 2
                )
            json.dump(rep, open(rp, "w"), indent=1)
            print(json.dumps(rep))
        return
    from kmer_id_tpu.config import ClassifyConfig
    from kmer_id_tpu.engine.pipeline import SampleProcessor, load_db, make_classifier

    wdir = meta["wdir"]
    cache_dir = os.path.join(CACHE, "packed")
    cold = not os.path.exists(os.path.join(cache_dir, "manifest.json"))
    t0 = time.time()
    db = load_db(
        os.path.join(wdir, "s_data.txt"), os.path.join(wdir, "s_tree.txt"),
        os.path.join(wdir, "s_probes.txt.gz"), num_targ=5982, cache_dir=cache_dir,
    )
    t_parse = time.time() - t0
    log(f"DB {'text parse + pack' if cold else 'artifact load'}: {t_parse:.1f}s "
        f"({len(db.packed)} probes)")

    t0 = time.time()
    cfg = ClassifyConfig.preset("vf6", batch_size=8192, max_len=160)
    clf = make_classifier(db, cfg, cache_dir=cache_dir)
    t_build = time.time() - t0
    fp = clf.fpdb
    tables = sum(
        int(v.nbytes) for v in clf._db.values()
        if hasattr(v, "nbytes") and getattr(v, "ndim", 0) > 0
    ) + fp.n_slots
    log(f"classifier {'fpdb build' if cold else 'fpdb load'} + device put: "
        f"{t_build:.1f}s; slots={fp.n_slots} "
        f"(L1 buckets {fp.nb}, L2 {fp.nb2}); device tables {tables / 1e9:.2f} GB")

    # warm load numbers (the per-startup production cost)
    t0 = time.time()
    db2 = load_db(
        os.path.join(wdir, "s_data.txt"), os.path.join(wdir, "s_tree.txt"),
        os.path.join(wdir, "s_probes.txt.gz"), num_targ=5982, cache_dir=cache_dir,
    )
    t_warm = time.time() - t0
    log(f"warm artifact load: {t_warm:.2f}s")

    warm = SampleProcessor(clf, cfg)
    from kmer_id_tpu.io.fastx import iter_fastq_gz

    recs = iter_fastq_gz(meta["reads"])
    warm.feed([next(recs) for _ in range(8192)])
    warm.finish()
    runs = []
    for i in range(args.runs):
        t0 = time.time()
        sp = SampleProcessor(clf, cfg)
        for _ in range(args.repeat_file):
            sp.feed_file(meta["reads"], fmt="fastq_gz")
        res = sp.finish()
        dt = time.time() - t0
        runs.append(res.reads / dt)
        log(f"run {i + 1}/{args.runs}: {res.reads} reads in {dt:.2f}s -> "
            f"{runs[-1]:,.0f} reads/s")

    # device-kernel probe at this scale (same methodology as bench.py)
    sys.path.insert(0, ROOT)
    import bench as B

    kern = B._kernel_throughput(clf)
    for k, v in kern.items():
        log(f"{k}: {v}")
    report = {
        "n_probes": meta["n_probes"],
        "reads_per_run": int(meta["n_reads"]) * args.repeat_file,
        **kern,
        "probe_text_gz_gb": round(meta["gz_bytes"] / 1e9, 2),
        "first_load_s": round(t_parse, 1) if cold else None,
        "fpdb_build_s": round(t_build, 1) if cold else None,
        "warm_load_s": round(t_warm, 2),
        "device_table_gb": round(tables / 1e9, 2),
        "l1_buckets": int(fp.nb),
        "l2_buckets": int(fp.nb2),
        "n_slots": int(fp.n_slots),
        "reads_per_sec": round(float(np.median(runs)), 1),
        "runs": [round(r, 1) for r in runs],
    }
    bl_path = os.path.join(CACHE, "baseline_1e8.json")
    if os.path.exists(bl_path):
        bl = json.load(open(bl_path))
        report["baseline_reads_per_sec"] = bl["reads_per_sec"]
        report["baseline_runs"] = bl["runs"]
        report["vs_baseline"] = round(
            report["reads_per_sec"] / bl["reads_per_sec"], 2
        )
    json.dump(report, open(os.path.join(CACHE, "scale_report.json"), "w"))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
