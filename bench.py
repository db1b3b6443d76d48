#!/usr/bin/env python
"""Benchmark: classification throughput vs the reference classifier, at
production (bact10) scale.

Fixture (cached in .bench_cache/, generated once): a bact10-scale synthetic
DB — the real b10 taxonomy/strain tables read from the reference checkout,
with 33M random discriminative probes (the real probes10.txt.gz is ~1.5 GB gz
text, README.md:12, i.e. the same order of magnitude) — plus 1M × 150bp
FASTQ.GZ reads with a realistic hit profile (most reads hit 1-3 probes of one
target, some mixed, some unclassified, low-quality tails to exercise trim),
and a long-read FASTA lane (1k × 10kb contigs).

Baseline: the reference classifier (kmer_read_vf6.cpp compiled UNMODIFIED,
with its production 2^30-cell / 24 GiB hash table), timed as
(full job − tiny job) to exclude DB text-parse + table-memset time.
Cached in .bench_cache/baseline_full.json.

Ours: end-to-end sample processing (gz decode → trim/pack → device classify →
counts) on the packed DB; p50 of N_RUNS timed passes after one warmup pass.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline", ...}.
A >15% p50 regression vs the best of the last 5 recorded runs is flagged in
the JSON (and stderr) via "regression".
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, ".bench_cache")
REF = "/root/reference"

N_PROBES = 33_000_000
N_READS = 1_000_000
READ_LEN = 150
N_RUNS = 5
N_LONG = 1000
LONG_LEN = 10_000
SEED = 20260819


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------- fixture


def _revcomp_vec(keys: np.ndarray) -> np.ndarray:
    """Vectorized 60-bit reverse complement."""
    k = keys.copy()
    out = np.zeros_like(k)
    three = np.uint64(3)
    for _ in range(30):
        out = (out << np.uint64(2)) | ((three - (k & three)) & three)
        k >>= np.uint64(2)
    return out


def _keys_to_char_matrix(keys: np.ndarray) -> np.ndarray:
    """Vectorized key -> [N, 30] uint8 base-character matrix."""
    shifts = np.array([2 * (29 - j) for j in range(30)], dtype=np.uint64)
    codes = ((keys[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes]


def _gen_fixture():
    os.makedirs(CACHE, exist_ok=True)
    done = os.path.join(CACHE, "fixture_full.json")
    if os.path.exists(done):
        return json.load(open(done))
    rng = np.random.default_rng(SEED)
    log(f"generating full-scale fixture ({N_PROBES / 1e6:.0f}M probes, one-time)...")

    wdir = os.path.join(CACHE, "bench10")
    os.makedirs(wdir, exist_ok=True)
    # bact10-shaped metadata from the reference checkout (read-only inputs)
    data_src = os.path.join(REF, "b10", "bData10.txt")
    tree_src = os.path.join(REF, "b10", "btree_10.txt")
    if os.path.exists(data_src):
        data_txt = open(data_src).read()
        tree_txt = open(tree_src).read()
        num_targ = 5982
    else:  # fallback synthetic taxonomy
        num_targ = 5982
        rows = [f"{rng.integers(2, num_targ)}\tACC{i:06d}" for i in range(14791)]
        data_txt = "\n".join(rows) + "\n"
        tree_txt = "\n".join(f"1\t{t}" for t in range(2, num_targ)) + "\n"
    open(os.path.join(wdir, "bench10_data.txt"), "w").write(data_txt)
    open(os.path.join(wdir, "bench10_tree.txt"), "w").write(tree_txt)

    # probes: random canonical keys, targets drawn from real target ids
    targs_pool = np.array(
        sorted({int(l.split()[0]) for l in data_txt.splitlines() if l.strip()}),
        dtype=np.int32,
    )
    targs_pool = targs_pool[targs_pool > 1]
    raw = rng.integers(0, 1 << 60, size=int(N_PROBES * 1.1), dtype=np.uint64)
    canon = np.minimum(raw, _revcomp_vec(raw))
    keys = np.unique(canon)[:N_PROBES]
    rng.shuffle(keys)
    targets = targs_pool[rng.integers(0, len(targs_pool), size=len(keys))]
    log(f"writing {len(keys)} probes (gz text)...")
    t0 = time.time()
    # fixed-width lines (30 bases + ",TTTT,0,0,F,3\n" = 44 B) written chunked
    with gzip.open(
        os.path.join(wdir, "bench10_probes.txt.gz"), "wb", compresslevel=1
    ) as f:
        CH = 1_000_000
        for s in range(0, len(keys), CH):
            ke = keys[s : s + CH]
            te = targets[s : s + CH]
            n = len(ke)
            lines = np.zeros((n, 44), dtype=np.uint8)
            lines[:, :30] = _keys_to_char_matrix(ke)
            lines[:, 30] = ord(",")
            d = te.astype(np.int64)
            for col, div in ((31, 1000), (32, 100), (33, 10), (34, 1)):
                lines[:, col] = ord("0") + (d // div) % 10
            lines[:, 35:44] = np.frombuffer(b",0,0,F,3\n", dtype=np.uint8)
            f.write(lines.tobytes())
    log(f"  probes written in {time.time() - t0:.0f}s")

    # short reads: vectorized planting of probe 30-mers
    log(f"writing {N_READS} reads...")
    t0 = time.time()
    base_chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = base_chars[rng.integers(0, 4, size=(N_READS, READ_LEN), dtype=np.uint8)]
    pcm = _keys_to_char_matrix(keys[:100_000])  # plantable probe subset
    ptargets = targets[:100_000]
    # per-target contiguous ranges for consistent-read sampling
    order = np.argsort(ptargets, kind="stable")
    ts = ptargets[order]
    tvals, tstart, tcount = np.unique(ts, return_index=True, return_counts=True)
    ok = tcount >= 3
    tvals, tstart, tcount = tvals[ok], tstart[ok], tcount[ok]
    kinds = rng.random(N_READS)
    cons = kinds < 0.6
    mixed = (kinds >= 0.6) & (kinds < 0.7)
    # consistent reads: 1-3 probes of one target
    ci = np.nonzero(cons)[0]
    tsel = rng.integers(0, len(tvals), size=len(ci))
    nplant = rng.integers(1, 4, size=len(ci))
    for j in range(3):
        m = nplant > j
        rows = ci[m]
        pidx = order[tstart[tsel[m]] + rng.integers(0, 1 << 31, size=len(rows)) % tcount[tsel[m]]]
        pos = rng.integers(0, READ_LEN - 30, size=len(rows))
        idx = pos[:, None] + np.arange(30)[None, :]
        reads[rows[:, None], idx] = pcm[pidx]
    # mixed reads: 2 probes of random targets
    mi = np.nonzero(mixed)[0]
    for j in range(2):
        pidx = rng.integers(0, len(pcm), size=len(mi))
        pos = rng.integers(0, READ_LEN - 30, size=len(mi))
        idx = pos[:, None] + np.arange(30)[None, :]
        reads[mi[:, None], idx] = pcm[pidx]
    qual = np.full((N_READS, READ_LEN), ord("J"), dtype=np.uint8)
    tail = rng.random(N_READS) < 0.1
    qual[tail, READ_LEN - 25 :] = ord("#")
    # fixed-width records: "@r0000000\n" + seq + "\n+\n" + qual + "\n"
    with gzip.open(os.path.join(CACHE, "reads.fastq.gz"), "wb", compresslevel=1) as f:
        CH = 100_000
        rec_len = 10 + READ_LEN + 1 + 2 + READ_LEN + 1
        for s in range(0, N_READS, CH):
            n = min(CH, N_READS - s)
            block = np.zeros((n, rec_len), dtype=np.uint8)
            block[:, 0] = ord("@")
            block[:, 1] = ord("r")
            d = (np.arange(s, s + n)).astype(np.int64)
            for col, div in zip(range(2, 9), (10**6, 10**5, 10**4, 10**3, 100, 10, 1)):
                block[:, col] = ord("0") + (d // div) % 10
            block[:, 9] = ord("\n")
            block[:, 10 : 10 + READ_LEN] = reads[s : s + n]
            block[:, 10 + READ_LEN] = ord("\n")
            block[:, 11 + READ_LEN] = ord("+")
            block[:, 12 + READ_LEN] = ord("\n")
            block[:, 13 + READ_LEN : 13 + 2 * READ_LEN] = qual[s : s + n]
            block[:, -1] = ord("\n")
            f.write(block.tobytes())
    log(f"  reads written in {time.time() - t0:.0f}s")

    # long-read FASTA lane: 10kb contigs, probes planted every ~500bp
    log(f"writing {N_LONG} long contigs...")
    contigs = base_chars[rng.integers(0, 4, size=(N_LONG, LONG_LEN), dtype=np.uint8)]
    for s in range(0, LONG_LEN - 30, 500):
        pidx = rng.integers(0, len(pcm), size=N_LONG)
        off = s + rng.integers(0, 470, size=N_LONG)
        idx = off[:, None] + np.arange(30)[None, :]
        contigs[np.arange(N_LONG)[:, None], idx] = pcm[pidx]
    with open(os.path.join(CACHE, "long.fasta"), "wb") as f:
        for i in range(N_LONG):
            f.write(b">c%d\n" % i)
            f.write(contigs[i].tobytes())
            f.write(b"\n")

    meta = {
        "wdir": wdir,
        "reads": os.path.join(CACHE, "reads.fastq.gz"),
        "long": os.path.join(CACHE, "long.fasta"),
        "n_reads": N_READS,
        "n_long": N_LONG,
        "long_len": LONG_LEN,
        "num_targ": num_targ,
        "n_probes": int(len(keys)),
    }
    json.dump(meta, open(done, "w"))
    return meta


# ----------------------------------------------------------------- baseline


def _reference_baseline(meta) -> dict:
    """Reference reads/sec at its production table size (2^30 cells, 24 GiB):
    MEDIAN OF 3 measured passes, with the spread recorded; cached.

    Methodology: ONE binary invocation running four jobs (tiny, then the
    1M-read job three times) so the DB text parse + 24 GiB table memset
    happen exactly once; each full pass's classify time is the mtime delta
    between consecutive jobs' ``_result.txt`` files (each is written as its
    job completes, kmer_read_vf6.cpp:1159-1162).  Cross-process differencing
    is hopeless here — load time (~3-5 min) varies more than the classify
    time — and a single-sample baseline drifted 21% across rounds
    (53.0k -> 41.6k reads/s on the earlier host), so the pinned number is a
    median with its min/max spread stored alongside.
    """
    bl_path = os.path.join(CACHE, "baseline_full.json")
    if os.path.exists(bl_path):
        bl = json.load(open(bl_path))
        if "runs" in bl:  # v2 methodology (median-of-3)
            return bl
        os.remove(bl_path)  # stale single-sample baseline: re-measure
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import golden_harness as gh

    binary = gh._compile("kmer_read_vf6.cpp", "ref_read_vf6_bench_full", [])
    if binary is None:
        return {"reads_per_sec": 0.0}
    workdir = os.path.join(CACHE, "refrun")
    jdir = os.path.join(workdir, "jobs")
    os.makedirs(jdir, exist_ok=True)
    os.makedirs(os.path.join(workdir, "bench10"), exist_ok=True)
    for f in os.listdir(meta["wdir"]):
        src = os.path.join(meta["wdir"], f)
        dst = os.path.join(workdir, "bench10", f)
        if not os.path.exists(dst):
            os.link(src, dst)
    # tiny job: first 100 reads
    tiny = os.path.join(CACHE, "reads_tiny.fastq.gz")
    if not os.path.exists(tiny):
        with gzip.open(meta["reads"], "rb") as fi, gzip.open(tiny, "wb") as fo:
            for _ in range(400):
                fo.write(fi.readline())

    open(os.path.join(jdir, "jobs.txt"), "w").write(
        f"tiny 1\n{tiny}\n"
        + "".join(f"full{i} 1\n{meta['reads']}\n" for i in range(3))
    )
    log("timing reference (one process: DB load + tiny job + 3x 1M-read jobs)...")
    t0 = time.time()
    r = subprocess.run(
        [binary, "-name", "bench10", "-jname", "jobs"],
        cwd=workdir, capture_output=True, text=True, timeout=14400,
    )
    assert r.returncode == 0, r.stdout[-500:] + r.stderr[-500:]
    wall = time.time() - t0
    marks = [os.path.getmtime(os.path.join(jdir, "tiny_result.txt"))] + [
        os.path.getmtime(os.path.join(jdir, f"full{i}_result.txt"))
        for i in range(3)
    ]
    runs = [
        meta["n_reads"] / max(b - a, 1e-3) for a, b in zip(marks, marks[1:])
    ]
    bl = {
        "reads_per_sec": float(np.median(runs)),
        "runs": [round(x, 1) for x in runs],
        "spread_pct": round(
            100.0 * (max(runs) - min(runs)) / float(np.median(runs)), 1
        ),
        "wall_s": wall,
    }
    json.dump(bl, open(bl_path, "w"))
    log(f"reference baseline: median {bl['reads_per_sec']:,.0f} reads/s of "
        f"{bl['runs']} (spread {bl['spread_pct']}%, wall {wall:.0f}s)")
    return bl


# ----------------------------------------------------------------- ours


def _hbm_bytes() -> int:
    import jax

    n = int(jax.local_devices()[0].memory_stats()["bytes_in_use"])
    if n <= 0:
        raise RuntimeError("device reports no memory in use after warmup")
    return n


def _our_throughput(meta) -> tuple[float, dict]:
    from kmer_id_tpu.config import ClassifyConfig
    from kmer_id_tpu.engine.pipeline import SampleProcessor, load_db, make_classifier
    from kmer_id_tpu.io.fastx import iter_fastq_gz

    wdir = meta["wdir"]
    t0 = time.time()
    db = load_db(
        os.path.join(wdir, "bench10_data.txt"),
        os.path.join(wdir, "bench10_tree.txt"),
        os.path.join(wdir, "bench10_probes.txt.gz"),
        num_targ=meta["num_targ"],
        cache_dir=os.path.join(CACHE, "packed_full"),
    )
    t_load = time.time() - t0
    log(f"DB load: {t_load:.1f}s ({len(db.packed)} probes)")

    t0 = time.time()
    bsz = int(os.environ.get("KMER_BENCH_BATCH", "8192"))
    cfg = ClassifyConfig.preset("vf6", batch_size=bsz, max_len=160)
    clf = make_classifier(db, cfg, cache_dir=os.path.join(CACHE, "packed_full"))
    t_clf = time.time() - t0
    from kmer_id_tpu.engine.fpclassify import FpClassifier

    engine = type(clf).__name__
    log(f"classifier ready in {t_clf:.1f}s (engine={engine}, "
        f"slots={getattr(getattr(clf, 'fpdb', None), 'n_slots', 0)})")
    assert isinstance(clf, FpClassifier), "flagship engine must load this DB"

    # warmup: compile on a small slice
    warm = SampleProcessor(clf, cfg)
    recs = iter_fastq_gz(meta["reads"])
    # 64k-read warmup: several batches, so every jit signature the timed
    # passes use is compiled before the first of them
    warm_records = [next(recs) for _ in range(65536)]
    warm.feed(warm_records)
    warm.finish()
    hbm = _hbm_bytes()
    # static device-table footprint (fingerprint tables + rec + seen bitmap)
    tables = sum(
        int(v.nbytes)
        for v in clf._db.values()
        if hasattr(v, "nbytes") and getattr(v, "ndim", 0) > 0
    ) + clf.fpdb.n_slots  # int8 seen
    log(f"warmup/compile done (HBM in use: {hbm / 1e9:.2f} GB; "
        f"device tables {tables / 1e9:.2f} GB)")

    runs = []
    classified = 0.0
    res = None
    for i in range(N_RUNS):
        t0 = time.time()
        sp = SampleProcessor(clf, cfg)
        sp.feed_file(meta["reads"], fmt="fastq_gz")
        res = sp.finish()
        dt = time.time() - t0
        rps = res.reads / dt
        classified = 100 * (1 - res.gcount[0] / max(res.reads, 1))
        log(f"run {i + 1}/{N_RUNS}: {res.reads} reads in {dt:.2f}s -> "
            f"{rps:,.0f} reads/s (classified {classified:.1f}%)")
        runs.append(rps)
    p50 = float(np.median(runs))

    # bench-scale output concordance vs the reference's own run of the SAME
    # 1M reads on the SAME 33M-probe DB (written during baseline timing):
    # per-target gcount/ucount lines must be byte-identical — this exercises
    # fingerprint/max_hits edge cases that only appear at production density
    conc = {}
    ref_result = os.path.join(CACHE, "refrun", "jobs", "full0_result.txt")
    if not os.path.exists(ref_result):  # pre-r4 baseline cache layout
        ref_result = os.path.join(CACHE, "refrun", "jobs", "full_result.txt")
    if res is not None and os.path.exists(ref_result):
        from kmer_id_tpu.engine.pipeline import write_result

        ours_path = os.path.join(CACHE, "our_full_result.txt")
        write_result(ours_path, res)
        ref_lines = open(ref_result, "rb").read().splitlines()
        our_lines = open(ours_path, "rb").read().splitlines()
        n = max(len(ref_lines), len(our_lines))
        eq = sum(
            1 for a, b in zip(ref_lines, our_lines) if a == b
        ) if n else 0
        gdiff = 0
        for a, b in zip(ref_lines, our_lines):
            if a != b:
                ga = int(a.split(b",")[1])
                gb = int(b.split(b",")[1])
                gdiff += abs(ga - gb)
        conc = {
            "result_identical": eq == n and len(ref_lines) == len(our_lines),
            "result_lines_equal_pct": round(100.0 * eq / max(n, 1), 3),
            "gcount_l1_diff": int(gdiff),
        }
        log(f"concordance vs reference result: identical={conc['result_identical']} "
            f"({conc['result_lines_equal_pct']}% lines, L1 gcount diff {gdiff})")

    # long-read FASTA lane (secondary metric); first pass compiles the
    # bucketed chunk-plane kernels, so warm separately
    sp = SampleProcessor(clf, cfg)
    sp.feed_file(meta["long"], fmt="fasta")
    sp.finish()
    t0 = time.time()
    sp = SampleProcessor(clf, cfg)
    sp.feed_file(meta["long"], fmt="fasta")
    lres = sp.finish()
    ldt = time.time() - t0
    lbps = meta["n_long"] * meta["long_len"] / ldt
    log(f"long-read lane: {meta['n_long']} x {meta['long_len']}bp in {ldt:.1f}s "
        f"-> {lbps / 1e6:.1f} Mbase/s")

    kernel = _kernel_throughput(clf)
    kernel.update(_sharded_kernel_throughput(db, clf))

    return p50, {
        "db_load_s": round(t_load, 2),
        # classifier-ready = fpdb cache load/build + device table puts; a
        # large value means a cold fpdb build (cache wiped or stale)
        "setup_s": round(t_clf, 1),
        "setup_slow": bool(t_clf > 180),
        "runs": [round(r, 1) for r in runs],
        "reads": int(meta["n_reads"]),
        "db_probes": int(len(db.packed)),
        "classified_pct": round(float(classified), 1),
        "hbm_bytes_in_use": hbm,  # device.memory_stats() after warmup
        "device_table_bytes": tables,
        "long_read_mbase_per_s": round(lbps / 1e6, 2),
        **conc,
        **kernel,
    }


def _kernel_throughput(clf) -> dict:
    """Device-kernel-only reads/s: an IN-JIT fori_loop over the full finals
    kernel with row-rolled inputs (no host decode, no transfers).  Uses the
    bench reads' first batch as the fixture so the hit profile matches the
    e2e run."""
    try:
        import jax
        import jax.numpy as jnp

        from kmer_id_tpu.engine.fpclassify import fp_finals
        from kmer_id_tpu.io.fastx import iter_fastq_gz
        from kmer_id_tpu.ops.extract import extract_kmers
        from kmer_id_tpu.core.codec import encode_bases

        B, L = clf.batch_size, clf.max_len
        codes = np.full((B, L), 4, np.uint8)
        lengths = np.zeros(B, np.int32)
        it = iter_fastq_gz(os.path.join(CACHE, "reads.fastq.gz"))
        for i in range(B):
            acc, seq, qual = next(it)
            c = encode_bases(seq)[:L]
            codes[i, : len(c)] = c
            lengths[i] = len(c)
        mh = clf.max_hits
        nsl = clf.fpdb.n_slots

        @jax.jit
        def run(d, cds, lens, iters):
            def step(i, carry):
                acc, seen = carry
                ex = extract_kmers(jnp.roll(cds, i, axis=0), lens)
                finals, seen = fp_finals(d, ex, seen, mh)
                return acc + finals.sum(), seen
            acc, seen = jax.lax.fori_loop(
                0, iters, step, (jnp.int32(0), jnp.zeros((nsl,), jnp.int8))
            )
            return acc + seen[0].astype(jnp.int32)

        iters = 100
        run(clf._db, jnp.asarray(codes), jnp.asarray(lengths), iters).block_until_ready()
        t0 = time.time()
        run(clf._db, jnp.asarray(codes), jnp.asarray(lengths), iters).block_until_ready()
        dt = (time.time() - t0) / iters
        return {
            "kernel_ms_per_batch": round(dt * 1000, 2),
            "kernel_reads_per_sec": round(B / dt, 1),
        }
    except Exception as e:  # pragma: no cover - diagnostics only
        log(f"kernel throughput probe failed: {e}")
        return {}


def _sharded_kernel_throughput(db, clf) -> dict:
    """ShardedFpClassifier step_finals on a (data=1, db=1) mesh over the
    card: the sharded code path's per-card overhead vs the flagship kernel
    (collectives are no-ops at mesh size 1, so the delta is the bloom-gate +
    narrow-budget + merge-sort formulation cost)."""
    try:
        import jax
        import jax.numpy as jnp

        from kmer_id_tpu.engine.pipeline import load_db  # noqa: F401
        from kmer_id_tpu.io.fastx import iter_fastq_gz
        from kmer_id_tpu.core.codec import encode_bases
        from kmer_id_tpu.parallel import ShardedFpClassifier, make_mesh

        B, L = clf.batch_size, clf.max_len
        mesh = make_mesh(data=1, db=1, devices=jax.devices()[:1])
        shard = ShardedFpClassifier(
            db.packed, db.taxonomy, mesh, batch_size=B, max_len=L,
            max_hits=clf.max_hits, fpdb=clf.fpdb,
        )
        codes = np.full((B, L), 4, np.uint8)
        lengths = np.zeros(B, np.int32)
        it = iter_fastq_gz(os.path.join(CACHE, "reads.fastq.gz"))
        for i in range(B):
            acc, seq, qual = next(it)
            c = encode_bases(seq)[:L]
            codes[i, : len(c)] = c
            lengths[i] = len(c)

        step = shard._step_finals
        args = (shard._fptab, shard._fptab2, shard._rec, shard._tinfo,
                shard._bloom_arr, shard._chain3)
        cj = jax.device_put(jnp.asarray(codes), shard._data_sh)
        lj = jax.device_put(jnp.asarray(lengths), shard._data_sh)

        def once(iters):
            acc = 0
            seen = shard.new_seen()
            for _ in range(iters):
                seen, finals, ovr = step(*args, seen, cj, lj, shard._salts)
            return jax.block_until_ready((finals, ovr))

        once(2)  # compile + warm
        iters = 20
        t0 = time.time()
        once(iters)
        dt = (time.time() - t0) / iters
        return {
            "sharded_kernel_ms_per_batch": round(dt * 1000, 2),
            "sharded_kernel_reads_per_sec": round(B / dt, 1),
        }
    except Exception as e:  # pragma: no cover - diagnostics only
        log(f"sharded kernel probe failed: {e}")
        return {}


def _history_guard(p50: float) -> dict:
    """Append to .bench_cache/history.jsonl; flag a >15% p50 drop vs the
    best of the last 5 recorded runs."""
    hist_path = os.path.join(CACHE, "history.jsonl")
    prior = []
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            prior = [json.loads(l) for l in f if l.strip()]
    recent = [h["p50"] for h in prior[-5:] if "p50" in h]
    out = {}
    if recent and p50 < 0.85 * max(recent):
        out["regression"] = {
            "p50": round(p50, 1),
            "best_recent": round(max(recent), 1),
            "drop_pct": round(100 * (1 - p50 / max(recent)), 1),
        }
        log(f"REGRESSION: p50 {p50:,.0f} is {out['regression']['drop_pct']}% "
            f"below best-of-last-5 {max(recent):,.0f}")
    commit = ""
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True,
        ).stdout.strip()
    except Exception:
        pass
    with open(hist_path, "a") as f:
        f.write(json.dumps({"ts": time.time(), "p50": p50, "commit": commit}) + "\n")
    return out


def main():
    from kmer_id_tpu.utils.device import device_summary, setup_compile_cache

    setup_compile_cache()
    log(f"devices: {device_summary()}")
    meta = _gen_fixture()
    bl = _reference_baseline(meta)
    ref_rps = bl.get("reads_per_sec", 0.0)
    ours_rps, extra = _our_throughput(meta)
    guard = _history_guard(ours_rps)
    out = {
        "metric": "reads_per_sec_per_chip",
        "value": round(ours_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(ours_rps / ref_rps, 3) if ref_rps else None,
        "baseline_reads_per_sec": round(ref_rps, 1),
        "baseline_runs": bl.get("runs"),
        "baseline_spread_pct": bl.get("spread_pct"),
        **extra,
        **guard,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
