#!/usr/bin/env python
"""Builder proof at multi-Mb genome scale: our sort-based 3-pass builder vs
the compiled reference builder on the SAME synthetic corpus.

The reference builds its bact10 DB from 14,791 multi-Mb genomes with a
128 GiB value-only hash table (kmer_build_vf6.cpp:37,142,648-848).  This
tool generates a corpus of multi-Mb genomes (default 200 x 5 Mb = 1 Gbase,
the scale of ~200 bacterial genomes), runs BOTH builders, and reports wall
time per pass, peak RSS, and probe-output equality.  The reference binary is compiled UNMODIFIED
except MAXHASH 2^35 -> 2^32 (16 GiB instead of 128 GiB).  NOTE: the shrink
is NOT semantics-free — the reference's value-only table merges colliding
keys, and 8x fewer cells raises its collision rate ~16x (~3.7% of keys at
a 1 Gbase corpus), which changes its probe emissions; probe byte-equality
therefore holds only on the collision-free golden tests, while count.txt
equality is asserted per-run here (SCALE.md §2 root-causes the diff).

Results: printed JSON + committed to SCALE.md by the author.

    python tools/builder_scale.py [--orgs 200] [--mb 5] [--skip-ref]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
CACHE = os.path.join(ROOT, ".bench_cache", "builder_scale")
NAME = "bscale"


def log(m):
    print(f"[bscale] {m}", file=sys.stderr, flush=True)


def gen_corpus(n_orgs: int, mb: int) -> str:
    """n_orgs genomes of mb megabases each; ~0.2% of each genome is a block
    shared with the next org (exercises CA-merge), one outgroup org listed
    in the filter file.  Deterministic; cached on disk."""
    os.makedirs(CACHE, exist_ok=True)
    marker = os.path.join(CACHE, f"corpus_{n_orgs}x{mb}.json")
    if os.path.exists(marker):
        return marker
    rng = np.random.default_rng(20260821)
    wdir = os.path.join(CACHE, NAME)
    fadir = os.path.join(CACHE, "fa")
    os.makedirs(wdir, exist_ok=True)
    os.makedirs(fadir, exist_ok=True)
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    glen = mb * 1_000_000
    shared_len = max(2000, glen // 500)
    t0 = time.time()
    prev_tail = None
    data_lines = []
    tree_lines = []

    def write_fa(path: str, acc: str, g: np.ndarray) -> None:
        """80-column wrapped FASTA (the reference's gz line reader has a
        fixed line buffer; real genome files are wrapped)."""
        n = len(g)
        rows = -(-n // 80)
        block = np.full((rows, 81), ord("\n"), dtype=np.uint8)
        pad = rows * 80 - n
        flat = np.concatenate([g, np.full(pad, ord("\n"), np.uint8)])
        block[:, :80] = flat.reshape(rows, 80)
        # padded cells hold '\n'; trim the final row to its real length
        body = block.tobytes()
        if pad:
            last = (n % 80) or 80
            body = block[:-1].tobytes() + block[-1, :last].tobytes() + b"\n"
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(b">" + acc.encode() + b"\n")
            f.write(body)

    for i in range(n_orgs):
        acc = f"g{i:04d}"
        targ = i + 2
        data_lines.append(f"{targ}\t{acc}")
        tree_lines.append(f"1\t{targ}")
        g = base[rng.integers(0, 4, size=glen, dtype=np.uint8)]
        if prev_tail is not None:  # shared block with previous org
            g[:shared_len] = prev_tail
        prev_tail = g[-shared_len:].copy()
        write_fa(os.path.join(fadir, acc + ".fasta.gz"), acc, g)
    # outgroup genome
    og = base[rng.integers(0, 4, size=glen // 10, dtype=np.uint8)]
    write_fa(os.path.join(fadir, "gOUT.fasta.gz"), "gOUT", og)
    open(os.path.join(wdir, f"{NAME}_data.txt"), "w").write(
        "\n".join(data_lines) + "\n"
    )
    open(os.path.join(wdir, f"{NAME}_tree.txt"), "w").write(
        "\n".join(tree_lines) + "\n"
    )
    open(os.path.join(wdir, f"{NAME}_filter.txt"), "w").write("gOUT\n")
    log(f"corpus written in {time.time() - t0:.0f}s "
        f"({n_orgs} x {mb} Mb + outgroup)")
    json.dump({"n_orgs": n_orgs, "mb": mb}, open(marker, "w"))
    return marker


def run_ours(spill: bool = False, rss_cap_gb: float = 0.0) -> dict:
    """Run our builder in a subprocess (isolated peak-RSS measurement).

    ``spill`` uses the bounded-memory disk-spill path (db/spill.py);
    ``rss_cap_gb`` > 0 additionally sets RLIMIT_DATA so the proof run
    CANNOT silently exceed the cap (it would die, not page)."""
    code = f"""
import json, os, resource, sys, time
sys.path.insert(0, {ROOT!r})
if {rss_cap_gb!r}:
    cap = int(float({rss_cap_gb!r}) * (1 << 30))
    resource.setrlimit(resource.RLIMIT_DATA, (cap, cap))
t0 = time.time()
if {spill!r}:
    from kmer_id_tpu.db.spill import build_probes_spill
    res = build_probes_spill({NAME!r}, {os.path.join(CACHE, 'fa')!r}, root={CACHE!r})
else:
    from kmer_id_tpu.db.build import build_probes
    res = build_probes({NAME!r}, {os.path.join(CACHE, 'fa')!r}, root={CACHE!r})
wall = time.time() - t0
rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(json.dumps(dict(wall_s=round(wall, 1), peak_rss_gb=round(rss, 2),
                      probes=int(len(res.records.keys)))))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=14400, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"ours: {out}")
    return out


def run_reference() -> dict:
    import golden_harness as gh

    binary = gh._compile(
        "kmer_build_vf6.cpp", "ref_build_scale",
        [("const ktype MAXHASH = (1LL << 35);",
          "const ktype MAXHASH = (1LL << 32);")],
    )
    if binary is None:
        return {}
    t0 = time.time()
    p = subprocess.Popen(
        [binary, "-name", NAME, "-fadir", os.path.join(CACHE, "fa") + "/"],
        cwd=CACHE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    out_txt, _ = p.communicate(timeout=14400)
    wall = time.time() - t0
    rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
    assert p.returncode == 0, out_txt[-2000:]
    probes = sum(1 for _ in open(os.path.join(CACHE, NAME, f"{NAME}_probes.txt")))
    out = dict(wall_s=round(wall, 1), peak_rss_gb=round(rss, 2), probes=probes)
    log(f"reference: {out}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--orgs", type=int, default=200)
    ap.add_argument("--mb", type=int, default=5)
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--spill", action="store_true",
                    help="bounded-memory disk-spill build (db/spill.py)")
    ap.add_argument("--rss-cap-gb", type=float, default=0.0,
                    help="hard RLIMIT_DATA cap for the ours run (proof mode)")
    args = ap.parse_args()
    gen_corpus(args.orgs, args.mb)
    report = {"n_orgs": args.orgs, "genome_mb": args.mb}

    probes_path = os.path.join(CACHE, NAME, f"{NAME}_probes.txt")
    ref = {} if args.skip_ref else run_reference()
    if ref:
        report["reference"] = ref
        os.rename(probes_path, probes_path + ".ref")
        os.rename(probes_path.replace("_probes", "_count"),
                  probes_path.replace("_probes", "_count") + ".ref")
    report["ours"] = run_ours(spill=args.spill, rss_cap_gb=args.rss_cap_gb)
    if args.spill:
        report["ours"]["spill"] = True
        report["ours"]["rss_cap_gb"] = args.rss_cap_gb
    if ref:
        same_p = open(probes_path, "rb").read() == open(
            probes_path + ".ref", "rb").read()
        same_c = open(probes_path.replace("_probes", "_count"), "rb").read() \
            == open(probes_path.replace("_probes", "_count") + ".ref", "rb").read()
        report["probes_byte_identical"] = bool(same_p)
        report["count_byte_identical"] = bool(same_c)
    json.dump(report, open(os.path.join(CACHE, "builder_scale_report.json"), "w"))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
