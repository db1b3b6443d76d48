"""Executed-reference parity for the two Python-2 orchestrators.

The two report paths without compiled-golden treatment:
``kmer_read_m3.py`` and ``kmer_readc.py``.  No python2 exists in this image,
so the interpreter of record is:

* ``kmer_readc.py`` — the ORIGINAL script byte-for-byte, executed under
  python3: it contains no py2-only syntax (no print statements, all divisions
  are float/ndarray), so py3 execution IS py2 execution for this program.
* ``kmer_read_m3.py`` — a test-time shim (``_shim_m3``) applying exactly four
  mechanical, py2-semantics-preserving edits (documented at the function);
  everything else, including the Popen of the compiled reference ``kmerread``
  binary, runs as shipped.

Both goldens drive the reference C++ classifier underneath, so these tests
pin the full classify→report pipeline, not just the report arithmetic.
"""

import gzip
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests import golden_harness as gh
from tests.test_golden_reference import rand_dna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"

# one line per target id 0..5 (the script indexes in_use[target] by line
# order); names need >= 5 '_'-ranks to pass the rank filter; target 3's
# count column is "5" on purpose: the reference's `count < 10.0` is a
# str-vs-float comparison that is ALWAYS False in py2 (numbers sort before
# strings), so the row must stay in use — a naive py3 port that "fixes" the
# comparison to float(count) < 10.0 would exclude it and fail this golden.
M3_REFKEY = (
    "target\tname\tcount\thit\ttested\tgsize\tnstrains\n"
    "0\tnone\t0\t0\t0\t0\t0\n"
    "1\troot\t0\t0\t0\t0\t0\n"
    "2\tk_p_c_o_genus\t50\t20\t40\t1000\t2\n"
    "3\tk_p_c_o_spA\t5\t20\t40\t1000\t1\n"
    "4\tk_p_c_o_spB\t50\t16\t30\t900\t1\n"
    "5\tk_p_c_o_spC\t50\t12\t30\t800\t1\n"
)


def _shim_m3(tmp_path) -> str:
    """Copy kmer_read_m3.py with four py2->py3 edits, each a no-op in py2:

    1. line 57's tab+8-space indent -> 16 spaces (py2 expands the tab to
       column 8, i.e. identical indentation; py3 rejects mixed tabs/spaces);
    2. bare ``print "x"`` statements -> ``print("x")`` (arg-error paths only,
       never reached here, but the file must parse);
    3. the inert count filter ``count < 10.0`` -> ``False``: in py2 a str
       always compares greater than a float (numeric types sort first), so
       the expression is constant-False; py3 would raise TypeError;
    4. ``open(f, 'r')`` -> ``open(f, 'r', newline='')``: py2's 'r' mode does
       no newline translation, so a CRLF refkey reaches the parser with its
       ``\\r`` intact (the ZeroDivision quirk below); py3's default
       universal-newline mode would silently strip it.
    """
    src = open(os.path.join(REF, "kmer_read_m3.py")).read()
    src = src.replace("\t        gensize", " " * 16 + "gensize")
    src = re.sub(r'print ("(?:[^"]*)")', r"print(\1)", src)
    assert "count < 10.0" in src
    src = src.replace("count < 10.0", "False")
    assert src.count(", 'r')") == 2
    src = src.replace(", 'r')", ", 'r', newline='')")
    path = str(tmp_path / "kmer_read_m3_shim.py")
    open(path, "w").write(src)
    return path


@pytest.fixture(scope="module")
def m3_world(tmp_path_factory):
    """Tiny mito world with the reference m3 classifier installed as the
    ``kmerread`` binary the orchestrator Popens (kmer_read_m3.py:70)."""
    build_bin = gh.build_binary()
    m3_bin = gh.classifier_m3_binary()
    if not build_bin or not m3_bin:
        pytest.skip("reference sources or g++ unavailable")
    root = tmp_path_factory.mktemp("py2m3")
    name = "mitochondria"
    wdir = root / name
    wdir.mkdir()
    fadir = root / "fa"
    fadir.mkdir()
    shared = rand_dna(280)
    genomes = {
        "mA": rand_dna(600) + shared,
        "mB": shared + rand_dna(600),
        "mC": rand_dna(700),
    }
    from kmer_id_tpu.core import codec

    ks = [codec.canonical_kmers(codec.encode_bases(g))[0] for g in genomes.values()]
    gh.assert_no_builder_collisions(np.concatenate(ks))
    for acc, seq in genomes.items():
        with gzip.open(fadir / f"{acc}.fasta.gz", "wt") as f:
            f.write(f">{acc}\n{seq}\n")
    (wdir / f"{name}_data.txt").write_text("3\tmA\n4\tmB\n5\tmC\n")
    (wdir / f"{name}_tree.txt").write_text("1\t2\n2\t3\n2\t4\n1\t5\n")
    (wdir / f"{name}_filter.txt").write_text("")
    r = gh.run(build_bin, ["-name", name, "-fadir", str(fadir) + "/"], cwd=str(root))
    assert r.returncode == 0, r.stdout + r.stderr
    gh.gzip_file(str(wdir / f"{name}_probes.txt"), str(wdir / f"{name}_probes.txt.gz"))
    (wdir / "mitochondria_refkey.txt").write_text(M3_REFKEY)
    shutil.copy(m3_bin, wdir / "kmerread")
    os.chmod(wdir / "kmerread", 0o755)

    reads = [
        ("m1", genomes["mA"][10:160]),
        ("m2", genomes["mB"][-160:-10]),
        ("m3", shared[10:160]),
        ("m4", rand_dna(150)),
        ("m5", genomes["mC"][100:250]),
    ]
    f1 = root / "reads1.fastq.gz"
    with gzip.open(f1, "wt") as f:
        for acc, seq in reads:
            f.write(f"@{acc}\n{seq}\n+\n{'J' * len(seq)}\n")
    return dict(root=root, wdir=wdir, f1=f1)


def test_m3_orchestrator_csv_bytes_match(m3_world, tmp_path):
    """Executed kmer_read_m3.py (shimmed, driving the compiled reference
    kmerread) vs our ``mitokmer`` CLI: byte-identical CSV."""
    shim = _shim_m3(tmp_path)
    wdir = str(m3_world["wdir"])
    ref_out = tmp_path / "ref_out"
    ref_out.mkdir()
    r = subprocess.run(
        [sys.executable, shim, "-w", wdir, "-d", str(ref_out),
         "-i", str(m3_world["f1"]), "none"],
        cwd=str(m3_world["root"]), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    ref_csv = (ref_out / "mitokmer_result.csv").read_bytes()
    assert b"total," in ref_csv

    our_out = tmp_path / "our_out"
    r = subprocess.run(
        [sys.executable, "-m", "kmer_id_tpu.cli", "mitokmer",
         "-w", wdir, "-d", str(our_out),
         "-i", str(m3_world["f1"]), "none"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    our_csv = (our_out / "mitokmer_result.csv").read_bytes()
    assert our_csv == ref_csv


def test_m3_orchestrator_crlf_zerodivision(m3_world, tmp_path):
    """The shipped refkey is CRLF; ``nstrains`` then parses as ``"0\\r"``
    which passes the ``!= '0'`` guard and divides by float("0\\r") == 0.0
    (kmer_read_m3.py:56-57).  Both the executed reference and our rollup
    must crash with ZeroDivisionError — parity includes the bug."""
    shim = _shim_m3(tmp_path)
    crlf_dir = tmp_path / "crlfw"
    shutil.copytree(m3_world["wdir"], crlf_dir)
    (crlf_dir / "mitochondria_refkey.txt").write_bytes(
        M3_REFKEY.replace("\n", "\r\n").encode()
    )
    out = tmp_path / "crlf_out"
    out.mkdir()
    r = subprocess.run(
        [sys.executable, shim, "-w", str(crlf_dir), "-d", str(out),
         "-i", str(m3_world["f1"]), "none"],
        cwd=str(m3_world["root"]), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode != 0 and "ZeroDivisionError" in r.stderr

    from kmer_id_tpu.report.rollup import m3_report

    # a result.txt exists in crlf_dir from the shim's kmerread run
    with pytest.raises(ZeroDivisionError):
        m3_report(
            str(crlf_dir / "result.txt"),
            str(crlf_dir / "mitochondria_refkey.txt"),
            str(out / "x.csv"),
        )


# --------------------------------------------------------------- kmer_readc


def _stage_readc_world(root, vf6_bin):
    """cwd layout the unmodified kmer_readc.py expects: ./chloroplast/ DB,
    ./jobs3c/jobs3c.txt, ./kmerreadc binary (names hard-coded at
    kmer_readc.py:9-19,67)."""
    build_bin = gh.build_binary()
    name = "chloroplast"
    wdir = root / name
    wdir.mkdir()
    fadir = root / "fa"
    fadir.mkdir()
    # genomes long enough that used targets clear the count > 35 in_use gate;
    # ~6k distinct 30-mers have a ~25% birthday-collision chance in the
    # reference builder's 2^26 table, so scan seeds for a collision-free world
    from kmer_id_tpu.core import codec

    bases = np.array(list("ACGT"))
    for seed in range(100):
        rng = np.random.default_rng(20260820 + seed)
        genomes = {
            acc: "".join(bases[rng.integers(0, 4, size=n)])
            for acc, n in (("cA", 2000), ("cB", 2000), ("cC", 400))
        }
        ks = np.concatenate(
            [codec.canonical_kmers(codec.encode_bases(g))[0] for g in genomes.values()]
        )
        try:
            gh.assert_no_builder_collisions(ks)
            break
        except AssertionError:
            continue
    else:
        pytest.fail("no collision-free seed found")
    for acc, seq in genomes.items():
        with gzip.open(fadir / f"{acc}.fasta.gz", "wt") as f:
            f.write(f">{acc}\n{seq}\n")
    (wdir / f"{name}_data.txt").write_text("2\tcA\n3\tcB\n4\tcC\n")
    (wdir / f"{name}_tree.txt").write_text("1\t2\n1\t3\n1\t4\n")
    (wdir / f"{name}_filter.txt").write_text("")
    r = gh.run(build_bin, ["-name", name, "-fadir", str(fadir) + "/"], cwd=str(root))
    assert r.returncode == 0, r.stdout + r.stderr
    gh.gzip_file(str(wdir / f"{name}_probes.txt"), str(wdir / f"{name}_probes.txt.gz"))
    (wdir / f"{name}_key.txt").write_text(
        "0\tnone\n1\troot\n2\tsp_cA\n3\tsp_cB\n4\tsp_cC\n"
    )
    # count.txt came from the builder; target 4 (400 bp genome, ~12 probes)
    # must fall under the > 35 gate, 2 and 3 must clear it
    counts = {
        int(l.split(",")[0]): int(l.split(",")[1])
        for l in (wdir / f"{name}_count.txt").read_text().splitlines()
    }
    assert counts[2] > 35 and counts[3] > 35 and counts[4] <= 35

    jdir = root / "jobs3c"
    jdir.mkdir()
    readsA = jdir / "a.fasta"
    noise = "".join(bases[rng.integers(0, 4, size=150)])  # deterministic: the
    # staging runs twice (reference cwd + ours) and must be byte-identical
    readsA.write_text(
        f">a1\n{genomes['cA'][100:250]}\n>a2\n{genomes['cB'][300:450]}\n"
        f">a3\n{noise}\n"
    )
    readsB = jdir / "b.fasta"
    readsB.write_text(
        f">b1\n{genomes['cB'][500:650]}\n>b2\n{genomes['cC'][50:200]}\n"
    )
    (jdir / "jobs3c.txt").write_text(
        f"jobA 1\n{readsA}\njobB 1\n{readsB}\n"
    )
    if vf6_bin:
        shutil.copy(vf6_bin, root / "kmerreadc")
        os.chmod(root / "kmerreadc", 0o755)


def test_readc_orchestrator_csv_bytes_match(tmp_path):
    """The UNMODIFIED kmer_readc.py executed under python3 (it is py2/py3
    bilingual — verified: no print statements, float-only arithmetic) driving
    the compiled reference classifier, vs our ``readc`` CLI."""
    build_bin = gh.build_binary()
    vf6_bin = gh.classifier_vf6_binary()
    if not build_bin or not vf6_bin:
        pytest.skip("reference sources or g++ unavailable")

    ref_root = tmp_path / "ref"
    ref_root.mkdir()
    _stage_readc_world(ref_root, vf6_bin)
    r = subprocess.run(
        [sys.executable, os.path.join(REF, "kmer_readc.py")],
        cwd=str(ref_root), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    ref_csv = (ref_root / "jobs3c" / "jobs3c.csv").read_bytes()
    assert ref_csv.startswith(b"name,jobA")

    our_root = tmp_path / "ours"
    our_root.mkdir()
    _stage_readc_world(our_root, None)
    r = subprocess.run(
        [sys.executable, "-m", "kmer_id_tpu.cli", "readc",
         "--jobs-name", "jobs3c", "--folder", "chloroplast",
         "--root", str(our_root), "--batch-size", "64", "--max-len", "192"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    our_csv = (our_root / "jobs3c" / "jobs3c.csv").read_bytes()
    assert our_csv == ref_csv
