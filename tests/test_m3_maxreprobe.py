"""The documented m3 MAXREPROBE divergence, pinned by construction.

The reference m3 classifier bounds LOOKUP probing at MAXREPROBE=16
(``kmer_read_m3.cpp:42,232``) while INSERT probes until an empty cell
(``kmer_read_m3.cpp:245-268``, unbounded).  A key whose insert landed deeper
than 16 triangular probes is therefore unfindable: a silent false miss.
kmer_id_tpu's engine is an exact dictionary (nx/vf6 semantics, adopted as
canonical per SURVEY §7); it classifies such reads.  This test constructs the
divergence deterministically and asserts both behaviors — the reference
false-misses, we don't — and that both agree on a key within the bound.

Construction: 17 canonical 30-mer keys all hashing to the same bucket of a
256-slot table (reference compiled with MAXHASH 2^30 -> 2^8, a
memory-size-only change; the golden harness uses the same trick).  256 slots
— not fewer — so the lookup loop's other bound ``reprobe < MAXHASH`` stays
slack (T(15) = 120 < 256) and ``i < MAXREPROBE`` is the binding constraint,
exactly as at the production 2^30 size.  Triangular probe offsets
T(j) = j(j+1)/2 are distinct mod 256 for j = 0..16, so insert #17 lands at
T(16) — one past the 16-probe lookup horizon — while insert #16 (at T(15)) is
the last reachable one.
"""

import gzip
import os

import numpy as np
import pytest

from kmer_id_tpu.core import codec
from tests import golden_harness as gh

MAXHASH_LOG2 = 8
NKEYS = 17


def _revcomp_vec(keys: np.ndarray) -> np.ndarray:
    k = keys.copy()
    out = np.zeros_like(k)
    three = np.uint64(3)
    for _ in range(30):
        out = (out << np.uint64(2)) | ((three - (k & three)) & three)
        k >>= np.uint64(2)
    return out


def _mine_chain_keys(bucket: int, n: int, seed: int = 7) -> np.ndarray:
    """n distinct canonical keys with murmur-fmix64(key) % 64 == bucket."""
    rng = np.random.default_rng(seed)
    found: list[int] = []
    seen: set[int] = set()
    while len(found) < n:
        raw = rng.integers(0, 1 << 60, size=200_000, dtype=np.uint64)
        canon = np.minimum(raw, _revcomp_vec(raw))
        h = gh.murmur_fmix64(canon) & np.uint64((1 << MAXHASH_LOG2) - 1)
        for k in canon[h == bucket]:
            k = int(k)
            if k not in seen:
                seen.add(k)
                found.append(k)
            if len(found) == n:
                break
    return np.array(found, dtype=np.uint64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    m3_tiny = gh._compile(
        "kmer_read_m3.cpp", "ref_read_m3_reprobe8", [("(1 << 30)", "(1 << 8)")]
    )
    if not m3_tiny:
        pytest.skip("reference sources or g++ unavailable")
    # probe offsets T(0..16) mod 64 must be pairwise distinct for the chain
    # construction to pin insert depth exactly
    offs = [(j * (j + 1) // 2) % (1 << MAXHASH_LOG2) for j in range(NKEYS)]
    assert len(set(offs)) == NKEYS

    keys = _mine_chain_keys(bucket=5, n=NKEYS)
    root = tmp_path_factory.mktemp("reprobe")
    wdir = root / "w"
    wdir.mkdir()
    (wdir / "mitochondria_data.txt").write_text("2\tmX\n")
    (wdir / "mitochondria_tree.txt").write_text("1\t2\n")
    with gzip.open(wdir / "mitochondria_probes.txt.gz", "wt") as f:
        for k in keys:  # file order = insert order
            f.write(f"{codec.key_to_string(int(k))},2,0,0,F,3\n")

    # read #16: last key reachable within the 16-probe lookup horizon;
    # read #17: the false-miss key (insert depth 17).  One extra base: the
    # m3 FASTA lane skips reads of length <= KSIZE and excludes the final
    # base (process_fa, kmer_read_m3.cpp:951-952 `> KSIZE` / `length()-1`).
    f1 = root / "reads.fasta"
    f1.write_text(
        f">within\n{codec.key_to_string(int(keys[15]))}A\n"
        f">beyond\n{codec.key_to_string(int(keys[16]))}A\n"
    )
    # tiny fixture: seconds when healthy.  Short timeout + retries deflake
    # the once-observed post-output wedge (ROADMAP C8) without
    # letting the full suite lose 10 minutes to it.
    r = gh.run(m3_tiny, ["-wdir", str(wdir) + "/", "-f1", str(f1), "-f2", "none"],
               cwd=str(root), timeout=90, retries=2)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = {}
    for line in (wdir / "result.txt").read_text().splitlines():
        t, g, u = line.split(",")
        ref[int(t)] = (int(g), int(u))
    (wdir / "result.txt").unlink()
    return dict(wdir=wdir, f1=f1, ref=ref)


def test_reference_false_misses_beyond_probe_bound(world):
    """The reference classifies only the within-bound read: gcount[2] == 1,
    the beyond-bound read lands on target 0 (unclassified)."""
    assert world["ref"][2][0] == 1
    assert world["ref"][0][0] == 1


def test_exact_dictionary_classifies_both(world):
    """kmer_id_tpu (exact dictionary) classifies both reads to target 2 —
    the documented, intended divergence (COMPONENTS.md 'm3 divergence')."""
    from kmer_id_tpu.config import ClassifyConfig
    from kmer_id_tpu.engine.pipeline import run_m3

    cfg = ClassifyConfig.preset("m3", batch_size=16, max_len=64)
    run_m3(str(world["wdir"]) + "/", str(world["f1"]), "none", cfg=cfg)
    got = {}
    for line in (world["wdir"] / "result.txt").read_text().splitlines():
        t, g, u = line.split(",")
        got[int(t)] = (int(g), int(u))
    assert got[2] == (2, 2)  # both reads classified, both keys unique-counted
    assert got[0][0] == 0
    # and on the within-bound read the two engines agree
    assert got[2][0] >= world["ref"][2][0]
