#!/usr/bin/env python
"""Smoke test of the production path on one GPU, at bact10 scale.

    python chip_smoke.py [--seed N]          # one card: the whole main path
    python chip_smoke.py --chips 4           # four cards: the two meshes only

What it does, in order:

1. Refuses to run unless JAX's default backend is a GPU (``JAX_PLATFORMS``
   defaults to ``cuda`` here, so a missing card is an error, not a CPU run).
2. Builds a bact10-shaped DB in memory from ``--seed``: 33,000,000 canonical
   30-mer probes over 5,982 targets of a synthetic tree (14,791 orgs), then
   ``pack_probes`` -> ``save_packed`` and ``build_fpdb`` -> ``save_fpdb``
   into a work directory (the artifact the ``pack-db`` path produces).
3. Writes one gzipped FASTQ sample (200,000 x 150 bp reads: planted probes
   of one target, mixed targets, unclassified, low-quality tails, N bases)
   and one FASTA sample (50 contigs of 2-20 kb, the long-read lane).
4. Starts the pure-Python reference simulator (tests/refsim.py) over the
   same reads in a child process that never touches the card.  It reads the
   probes as step 2 generated them, before packing, so a fault in packing,
   sorting or the artifact's I/O shows as a difference.
5. Classifies both samples through
   ``kmer_id_tpu.cli.main(["classify-jobs", ...])`` in this process, with
   the native decoder.
6. Compiles each jitted step at these widths and prints the finals step's
   ``memory_analysis()`` and the device's peak bytes in use.
7. Requires ``<job>_result.txt`` and ``<job>_reads.txt`` to be
   byte-identical to the simulator's.

With ``--chips 4`` it skips step 6 and classifies through a (data=1, db=4)
and then a (data=4, db=1) mesh in one process.

The last line of stdout is ``{"ok": true, "device": {...}}``; any failure
exits non-zero before it.
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cuda")

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_PROBES = 33_000_000
NUM_TARG = 5982
N_ORGS = 14_791
N_READS = 200_000
READ_LEN = 150
N_CONTIGS = 50
BATCH = 8192
MAX_LEN = 160
SEED = 20261016


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ------------------------------------------------------------------- device


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip()


def check_device() -> dict:
    """Platform, kind and count of JAX's devices; exits unless they are GPUs."""
    import jax

    from kmer_id_tpu.utils.device import device_summary

    d = device_summary()
    if d["platform"] != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX is on {d['platform']}")
    say(f"card: {gpu_line()}")
    say(f"jax {jax.__version__}: platform={d['platform']} kind={d['kind']} "
        f"count={d['count']}")
    return d


# --------------------------------------------------------------------- data


def _revcomp(keys: np.ndarray) -> np.ndarray:
    k = keys.copy()
    out = np.zeros_like(k)
    three = np.uint64(3)
    for _ in range(30):
        out = (out << np.uint64(2)) | (three - (k & three))
        k >>= np.uint64(2)
    return out


def _key_chars(keys: np.ndarray) -> np.ndarray:
    """uint64 keys -> [N, 30] ASCII bases, most significant base first."""
    shifts = np.array([2 * (29 - j) for j in range(30)], dtype=np.uint64)
    codes = ((keys[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return np.frombuffer(b"ACGT", dtype=np.uint8)[codes]


def _revcomp_chars(chars: np.ndarray) -> np.ndarray:
    lut = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        lut[a] = b
    return lut[chars[:, ::-1]]


def make_db(work: str, n_probes: int = N_PROBES, num_targ: int = NUM_TARG,
            n_orgs: int = N_ORGS, seed: int = SEED) -> dict:
    """Write ``<work>/b10`` metadata and the packed + fingerprint artifact in
    ``<work>/packed``, and the generated probes in ``<work>/probes.npz`` for
    the reference.  Returns the generated keys, targets and parent table."""
    from kmer_id_tpu.core.taxonomy import Taxonomy
    from kmer_id_tpu.db.fpdb import build_fpdb, save_fpdb
    from kmer_id_tpu.db.probes import ProbeRecords, pack_probes, save_packed

    rng = np.random.default_rng(seed)
    # synthetic tree: parent[t] uniform over earlier nodes (depth ~ ln n)
    parent = np.ones(num_targ, dtype=np.int64)
    for t in range(2, num_targ):
        parent[t] = rng.integers(1, t)
    dbdir = os.path.join(work, "b10")
    os.makedirs(dbdir, exist_ok=True)
    org_t = np.concatenate([
        np.arange(2, num_targ), rng.integers(2, num_targ, size=n_orgs - num_targ + 2)
    ])
    with open(os.path.join(dbdir, "b10_data.txt"), "w") as f:
        f.writelines(f"{t}\tACC{i:06d}\n" for i, t in enumerate(org_t))
    with open(os.path.join(dbdir, "b10_tree.txt"), "w") as f:
        f.writelines(f"{parent[t]}\t{t}\n" for t in range(2, num_targ))

    raw = rng.integers(0, 1 << 60, size=int(n_probes * 1.02) + 16, dtype=np.uint64)
    keys = np.unique(np.minimum(raw, _revcomp(raw)))
    keys = keys[np.sort(rng.permutation(len(keys))[:n_probes])]
    targets = rng.integers(2, num_targ, size=len(keys)).astype(np.int32)
    n = len(keys)
    probes = os.path.join(work, "probes.npz")
    np.savez(probes, keys=keys, targets=targets)
    rec = ProbeRecords(
        keys=keys, target=targets,
        org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
        fstrand=np.ones(n, bool), count=np.ones(n, np.int32),
    )
    t0 = time.time()
    packed = pack_probes(rec, num_targ=num_targ)
    cache = os.path.join(work, "packed")
    save_packed(packed, cache)
    t1 = time.time()
    edges = [(int(parent[t]), t) for t in range(2, num_targ)]
    fp = build_fpdb(packed, Taxonomy.from_edges(edges, num_nodes=num_targ))
    save_fpdb(fp, cache)
    say(f"db: {len(packed)} probes, {num_targ} targets, {fp.n_slots} slots "
        f"(pack+save {t1 - t0:.1f} s, fpdb {time.time() - t1:.1f} s)")
    return {"keys": keys, "targets": targets, "probes": probes,
            "parent": parent, "num_targ": num_targ, "cache": cache}


def make_samples(work: str, db: dict, n_reads: int = N_READS,
                 n_contigs: int = N_CONTIGS, read_len: int = READ_LEN,
                 contig_len=(2000, 20000), seed: int = SEED) -> dict:
    """Write the FASTQ and FASTA samples and the job list ``jobs/jobs.txt``."""
    rng = np.random.default_rng(seed + 1)
    keys, targets = db["keys"], db["targets"]
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = rng.choice(len(keys), size=min(len(keys), 100_000), replace=False)
    pcm = _key_chars(keys[pool])
    prc = _revcomp_chars(pcm)
    ptarg = targets[pool]
    order = np.argsort(ptarg, kind="stable")
    tvals, tstart, tcount = np.unique(ptarg[order], return_index=True,
                                      return_counts=True)

    def plant(rows_arr, pidx, seqs, length):
        pos = rng.integers(0, length - 30, size=len(rows_arr))
        cols = pos[:, None] + np.arange(30)[None, :]
        rc = rng.random(len(rows_arr)) < 0.5
        seqs[rows_arr[:, None], cols] = np.where(rc[:, None], prc[pidx], pcm[pidx])

    reads = base[rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)]
    kind = rng.random(n_reads)
    cons = np.nonzero(kind < 0.6)[0]  # 1-3 probes of one target
    tsel = rng.integers(0, len(tvals), size=len(cons))
    nplant = rng.integers(1, 4, size=len(cons))
    for j in range(3):
        m = nplant > j
        pidx = order[tstart[tsel[m]] + rng.integers(0, 1 << 31, size=m.sum())
                     % tcount[tsel[m]]]
        plant(cons[m], pidx, reads, read_len)
    mixed = np.nonzero((kind >= 0.6) & (kind < 0.7))[0]  # 2 random probes
    for _ in range(2):
        plant(mixed, rng.integers(0, len(pool), size=len(mixed)), reads, read_len)
    nrows = np.nonzero(rng.random(n_reads) < 0.02)[0]
    reads[nrows, rng.integers(0, read_len, size=len(nrows))] = ord("N")
    qual = np.full((n_reads, read_len), ord("J"), dtype=np.uint8)
    qual[rng.random(n_reads) < 0.1, read_len - 25:] = ord("#")
    fq = os.path.join(work, "reads.fastq.gz")
    with gzip.open(fq, "wb", compresslevel=1) as f:
        for s in range(0, n_reads, 50_000):
            f.write(b"".join(
                b"@r%07d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), qual[i].tobytes())
                for i in range(s, min(s + 50_000, n_reads))
            ))

    fa = os.path.join(work, "contigs.fasta")
    with open(fa, "wb") as f:
        for c in range(n_contigs):
            n = int(rng.integers(contig_len[0], contig_len[1] + 1))
            seq = base[rng.integers(0, 4, size=(1, n), dtype=np.uint8)]
            one = c % 2 == 0  # even contigs: probes of one target only
            t = int(rng.integers(0, len(tvals)))
            starts = np.arange(0, n - 530, 500)
            for s in starts:
                if one:
                    p = order[tstart[t] + int(rng.integers(0, tcount[t]))]
                else:
                    p = int(rng.integers(0, len(pool)))
                off = int(s + rng.integers(0, 470))
                seq[0, off:off + 30] = pcm[p]
            if c % 5 == 0:
                seq[0, rng.integers(0, n, size=3)] = ord("N")
            f.write(b">contig%d\n%s\n" % (c, seq[0].tobytes()))

    jdir = os.path.join(work, "jobs")
    os.makedirs(jdir, exist_ok=True)
    with open(os.path.join(jdir, "jobs.txt"), "w") as f:
        f.write(f"fq 1\n{fq}\nfa 1\n{fa}\n")
    say(f"samples: {n_reads} x {read_len} bp FASTQ, {n_contigs} FASTA contigs")
    return {"fq": fq, "fa": fa, "jobs": jdir}


# ---------------------------------------------------------------- reference


def _sample_keys(records) -> np.ndarray:
    """Canonical keys of every 30-base window of the records (a superset of
    the keys the reference looks up; windows over non-ACGT bases included)."""
    from kmer_id_tpu.core.codec import CODE_LUT_U

    out = []
    by_len: dict[int, list[bytes]] = {}
    for _, seq, _ in records:
        if len(seq) >= 30:
            by_len.setdefault(len(seq), []).append(seq.encode("latin-1"))
    for length, seqs in by_len.items():
        codes = np.minimum(
            CODE_LUT_U[np.frombuffer(b"".join(seqs), np.uint8)], 3
        ).astype(np.uint64).reshape(len(seqs), length)
        w = length - 29
        f = np.zeros((len(seqs), w), np.uint64)
        r = np.zeros((len(seqs), w), np.uint64)
        for j in range(30):
            c = codes[:, j:j + w]
            f = (f << np.uint64(2)) | c
            r |= (np.uint64(3) - c) << np.uint64(2 * j)
        out.append(np.minimum(f, r).reshape(-1))
    return np.unique(np.concatenate(out)) if out else np.zeros(0, np.uint64)


def reference_outputs(db: dict, samples: dict) -> dict:
    """Expected ``<job>_result.txt`` / ``<job>_reads.txt`` text per job, from
    the pure-Python simulator over the DB keys that occur in the sample."""
    from kmer_id_tpu.io.fastx import iter_fasta_plain, iter_fastq_gz
    from tests.refsim import RefSim

    t0 = time.time()
    out = {}
    parent = [int(p) for p in db["parent"]]
    for job, recs in (("fq", list(iter_fastq_gz(samples["fq"]))),
                      ("fa", list(iter_fasta_plain(samples["fa"])))):
        sk = _sample_keys(recs)
        hit = np.isin(db["keys"], sk)
        probes = dict(zip(db["keys"][hit].tolist(), db["targets"][hit].tolist()))
        sim = RefSim(probes, parent, num_targ=db["num_targ"], u_is_t=True)
        sim.feed(recs)
        out[job] = (
            "".join(line + "\n" for line in sim.result_lines()),
            "".join(f">{t}:{a}\n{s}\n" for t, a, s in sim.saved),
        )
    say(f"reference simulator: {time.time() - t0:.1f} s")
    return out


def _reference_child(conn, probes: str, parent, num_targ: int,
                     samples: dict) -> None:
    """Child-process body: the simulator over the generated probes."""
    with np.load(probes) as z:
        db = {"keys": z["keys"], "targets": z["targets"], "parent": parent,
              "num_targ": num_targ}
    conn.send(reference_outputs(db, samples))
    conn.close()


def start_reference(db: dict, samples: dict):
    """Run :func:`reference_outputs` in a child process, so the simulator
    (pure Python, minutes at full size) overlaps classification.  The child
    never imports JAX, so the card stays this process's alone.  Returns a
    function that waits for the child and returns its outputs."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(
        target=_reference_child,
        args=(send, db["probes"], db["parent"], db["num_targ"], samples),
    )
    child.start()
    send.close()

    def wait() -> dict:
        try:
            out = recv.recv()  # EOFError if the child died
        finally:
            child.join()
        if child.exitcode != 0:
            raise SystemExit(f"reference simulator exited {child.exitcode}")
        return out

    return wait


# ----------------------------------------------------------------- classify


def run_cli(work: str, db: dict, mesh_data: int = 1, mesh_db: int = 1,
            batch: int = BATCH, max_len: int = MAX_LEN) -> float:
    """classify-jobs through the CLI, in this process; returns seconds."""
    from kmer_id_tpu import cli
    from kmer_id_tpu.io.native_feed import native_available

    if not native_available():
        raise SystemExit("the native FASTQ/FASTA decoder failed to build")
    t0 = time.time()
    rc = cli.main([
        "classify-jobs", "-name", "b10", "-jname", "jobs", "--root", work,
        "--cache-dir", db["cache"], "--batch-size", str(batch),
        "--max-len", str(max_len),
        "--mesh-data", str(mesh_data), "--mesh-db", str(mesh_db),
    ])
    if rc != 0:
        raise SystemExit(f"classify-jobs exited {rc}")
    dt = time.time() - t0
    say(f"classify-jobs mesh=({mesh_data},{mesh_db}): {dt:.1f} s "
        "(DB load, compile and both samples)")
    return dt


def compare(work: str, expected: dict, label: str) -> None:
    """Byte-equality of every job's result and saved-reads files."""
    for job, (res, reads) in expected.items():
        for suffix, want in (("_result.txt", res), ("_reads.txt", reads)):
            path = os.path.join(work, "jobs", job + suffix)
            with open(path) as f:
                got = f.read()
            if got != want:
                raise SystemExit(f"{label}: {job}{suffix} differs from the "
                                 "reference simulator")
        classified = sum(
            int(line.split(",")[1]) for line in res.splitlines()[1:]
        )
        say(f"{label}: {job}_result.txt and {job}_reads.txt byte-identical "
            f"to the reference ({classified} reads classified, "
            f"{reads.count('>')} saved)")


# ------------------------------------------------------------------ compile


def compile_report(db: dict, batch: int = BATCH, max_len: int = MAX_LEN) -> None:
    """Compile each jitted step of the production path at these widths."""
    import jax
    import jax.numpy as jnp

    from kmer_id_tpu.core.taxonomy import Taxonomy
    from kmer_id_tpu.db.fpdb import load_fpdb
    from kmer_id_tpu.engine import fpclassify as F
    from kmer_id_tpu.io.batch import EXC_CAP

    fp = load_fpdb(db["cache"])
    parent = db["parent"]
    tax = Taxonomy.from_edges(
        [(int(parent[t]), t) for t in range(2, db["num_targ"])],
        num_nodes=db["num_targ"],
    )

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)

    dbs = {k: sds(np.shape(v), np.asarray(v).dtype)
           for k, v in F.device_tables(fp, tax).items()}
    words = -(-max_len // 16)
    packed = sds((batch, words), jnp.uint32)
    exc = sds((EXC_CAP,), jnp.int32)
    lens = sds((batch,), jnp.int32)
    seen = sds((fp.n_slots,), jnp.int8)
    steps = {
        "finals": F._fp_finals_packed.lower(
            dbs, packed, exc, lens, seen, l=max_len, max_hits=32),
        "long_finals": F._fp_long_packed.lower(
            dbs, packed, exc, lens, lens, seen, l=max_len, n_segs=batch + 1,
            max_hits=F.LONG_HITS),
        "slots": F._fp_kernel_packed.lower(
            dbs, packed, exc, lens, l=max_len, max_hits=32, mode="slots"),
        "ucount": F._ucount_device.lower(
            seen, sds((fp.n_slots,), jnp.int32), num_targ=db["num_targ"]),
    }
    for name, lowered in steps.items():
        t0 = time.time()
        compiled = lowered.compile()
        ma = compiled.memory_analysis()
        say(f"compiled {name} in {time.time() - t0:.1f} s: "
            f"args {ma.argument_size_in_bytes} B, out {ma.output_size_in_bytes} B, "
            f"temp {ma.temp_size_in_bytes} B, alias {ma.alias_size_in_bytes} B")


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats()
    peak = int(stats["peak_bytes_in_use"])
    if peak <= 0:
        raise SystemExit("device reports no memory in use")
    return peak


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: classify through the two four-card meshes only")
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)

    from kmer_id_tpu.utils.device import setup_compile_cache

    cache_dir = setup_compile_cache()
    dev = check_device()
    say(f"compile cache: {cache_dir}")
    if args.chips == 4 and dev["count"] < 4:
        raise SystemExit(f"--chips 4 needs four cards, JAX sees {dev['count']}")
    t_all = time.time()
    with tempfile.TemporaryDirectory(prefix="kmer_smoke_") as work:
        db = make_db(work, seed=args.seed)
        samples = make_samples(work, db, seed=args.seed)
        reference = start_reference(db, samples)
        if args.chips == 4:
            run_cli(work, db, 1, 4)
            expected = reference()
            compare(work, expected, "mesh (1, 4)")
            run_cli(work, db, 4, 1)
            compare(work, expected, "mesh (4, 1)")
        else:
            run_cli(work, db)
            compile_report(db)
            compare(work, reference(), "one card")
        say(f"peak device bytes in use: {peak_bytes()}")
    say(f"total {time.time() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
