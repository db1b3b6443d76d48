"""Fingerprint engine (engine/fpclassify.py): exactness vs the reference
simulator, fpdb invariants, and packed-transfer round-trips."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kmer_id_tpu.config import ClassifyConfig  # noqa: E402
from kmer_id_tpu.core import codec  # noqa: E402
from kmer_id_tpu.core.taxonomy import Taxonomy  # noqa: E402
from kmer_id_tpu.db.fpdb import build_fpdb, fp_hashes, load_fpdb, save_fpdb, verify_fpdb  # noqa: E402
from kmer_id_tpu.db.probes import ProbeRecords, pack_probes  # noqa: E402
from kmer_id_tpu.engine.fpclassify import FpClassifier, unpack_codes  # noqa: E402
from kmer_id_tpu.engine.pipeline import SampleProcessor  # noqa: E402
from kmer_id_tpu.io.batch import pack_codes  # noqa: E402
from kmer_id_tpu.ops.lookup import fp_hashes_jnp  # noqa: E402
from tests.refsim import RefSim  # noqa: E402
from tests.test_classify_e2e import make_db, make_reads, rand_dna  # noqa: E402

rng = np.random.default_rng(11)


@pytest.fixture(scope="module")
def world():
    rec, kmap = make_db()
    parent = [1] * 8
    parent[3] = 2
    parent[4] = 2
    parent[5] = 4
    parent[6] = 1
    parent[7] = 6
    tax = Taxonomy(np.array(parent, dtype=np.int32))
    packed = pack_probes(rec, num_targ=8)
    return rec, kmap, parent, tax, packed


def test_fpdb_invariants_and_roundtrip(tmp_path, world):
    _, _, _, tax, packed = world
    fp = build_fpdb(packed, tax)
    verify_fpdb(fp, packed.hi, packed.lo)
    # every key resolves to its own slot: target/idx maps line up
    b1, b2, f = fp_hashes(packed.hi, packed.lo, fp.nb, fp.s1, fp.s2, fp.s3)
    order = np.argsort(fp.slot_idx[fp.slot_idx >= 0])
    assert (np.sort(fp.slot_idx[fp.slot_idx >= 0]) == np.arange(len(packed))).all()
    # host/device hash twins agree bit-for-bit
    import jax.numpy as jnp

    db1, db2, dfp = fp_hashes_jnp(
        jnp.asarray(packed.hi), jnp.asarray(packed.lo), fp.nb, fp.s1, fp.s2, fp.s3
    )
    assert (np.asarray(db1) == b1).all()
    assert (np.asarray(db2) == b2).all()
    assert (np.asarray(dfp).astype(np.uint16) == f).all()
    # persistence
    save_fpdb(fp, tmp_path)
    fp2 = load_fpdb(tmp_path)
    assert (np.asarray(fp2.fptab) == fp.fptab).all()
    assert (np.asarray(fp2.fptab2) == fp.fptab2).all()
    assert (np.asarray(fp2.rec) == fp.rec).all()
    assert fp2.nb == fp.nb and fp2.nb2 == fp.nb2 and fp2.s3 == fp.s3


def test_pack_codes_roundtrip():
    from kmer_id_tpu.core.codec import INVALID

    b, l = 17, 103
    codes = rng.integers(0, 4, size=(b, l)).astype(np.uint8)
    lengths = rng.integers(0, l + 1, size=b).astype(np.int32)
    # sprinkle invalid bases inside and outside lengths
    for _ in range(40):
        codes[rng.integers(0, b), rng.integers(0, l)] = INVALID
    packed, exc = pack_codes(codes, lengths)
    got = np.asarray(unpack_codes(packed, exc, l))
    inlen = np.arange(l)[None, :] < lengths[:, None]
    # in-length positions reproduce exactly (incl. invalid marks)
    want = np.where(codes >= 4, 4, codes)
    assert (got[inlen] == want[inlen]).all()


@pytest.mark.parametrize("batch_size,max_len", [(16, 96), (64, 64)])
def test_fp_engine_matches_refsim(world, batch_size, max_len):
    rec, kmap, parent, tax, packed = world
    records = make_reads(kmap, n=300, read_len=90)

    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)

    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=batch_size, max_len=max_len)
    clf = FpClassifier(packed, tax, batch_size=batch_size, max_len=max_len)
    sp = SampleProcessor(clf, cfg)
    sp.feed(records)
    res = sp.finish()

    assert res.reads == sim.reads
    assert res.gcount.tolist() == sim.gcount
    assert res.ucount.tolist() == sim.ucount


@pytest.mark.chip
def test_fp_engine_matches_refsim_on_gpu(world, gpu):
    """The same exactness check with every kernel compiled for the card."""
    rec, kmap, parent, tax, packed = world
    records = make_reads(kmap, n=300, read_len=90)
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)
    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=64, max_len=96)
    clf = FpClassifier(packed, tax, batch_size=64, max_len=96)
    assert clf._db["rec"].devices() == {gpu}
    assert clf.new_seen().devices() == {gpu}
    sp = SampleProcessor(clf, cfg)
    sp.feed(records)
    res = sp.finish()
    assert res.reads == sim.reads
    assert res.gcount.tolist() == sim.gcount
    assert res.ucount.tolist() == sim.ucount


def test_fp_engine_long_reads(world):
    rec, kmap, parent, tax, packed = world
    records = []
    for i in range(6):
        parts = []
        for _ in range(8):
            parts.append(rand_dna(int(rng.integers(50, 300))))
            k = list(kmap)[int(rng.integers(len(kmap)))]
            parts.append(codec.key_to_string(k))
            if rng.random() < 0.3:
                parts.append("N")
        records.append((f"c{i}", "".join(parts), None))
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)

    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=8, max_len=128)
    clf = FpClassifier(packed, tax, batch_size=8, max_len=128)
    sp = SampleProcessor(clf, cfg)
    sp.feed(records)
    res = sp.finish()
    assert res.gcount.tolist() == sim.gcount
    assert res.ucount.tolist() == sim.ucount


def test_fp_engine_overflow_reads(world):
    """Reads with more hits than max_hits exercise the slots fallback."""
    rec, kmap, parent, tax, packed = world
    keys = list(kmap)
    records = []
    for i in range(5):
        # 40+ probe k-mers back to back in one 500 bp read
        seq = "".join(
            codec.key_to_string(keys[int(rng.integers(len(keys)))]) for _ in range(14)
        )
        records.append((f"h{i}", seq, None))
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)

    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=8, max_len=512)
    clf = FpClassifier(packed, tax, batch_size=8, max_len=512, max_hits=8)
    sp = SampleProcessor(clf, cfg)
    sp.feed(records)
    res = sp.finish()
    assert res.gcount.tolist() == sim.gcount
    assert res.ucount.tolist() == sim.ucount


def test_bloom_invariants(world):
    """Host/device bloom hash twins agree; the filter has NO false negatives
    (every DB key passes), and random absent keys pass at a low rate."""
    import jax.numpy as jnp

    from kmer_id_tpu.db.fpdb import bloom_hashes
    from kmer_id_tpu.ops.lookup import bloom_hashes_jnp, bloom_pass

    _, _, _, tax, packed = world
    fp = build_fpdb(packed, tax)
    assert fp.bloom is not None
    nblk = fp.bloom.shape[0]
    hb, hbits = bloom_hashes(packed.hi, packed.lo, nblk, fp.s4, fp.s5)
    db, dbits = bloom_hashes_jnp(
        jnp.asarray(packed.hi), jnp.asarray(packed.lo), nblk, fp.s4, fp.s5
    )
    assert (np.asarray(db) == hb).all()
    assert len(hbits) == len(dbits)
    for hb_, db_ in zip(hbits, dbits):
        assert (np.asarray(db_) == hb_).all()

    dbd = {
        "bloom": jnp.asarray(fp.bloom),
        "fp_s4": jnp.uint32(fp.s4),
        "fp_s5": jnp.uint32(fp.s5),
    }
    ok = bloom_pass(
        dbd, jnp.asarray(packed.hi), jnp.asarray(packed.lo),
        jnp.ones(len(packed), bool),
    )
    assert np.asarray(ok).all(), "bloom false negative"
    # absent keys: pass rate must be far below 1 (tiny test filter => loose)
    r = np.random.default_rng(3)
    ahi = r.integers(0, 1 << 28, size=4096).astype(np.uint32)
    alo = r.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    miss = bloom_pass(dbd, jnp.asarray(ahi), jnp.asarray(alo), jnp.ones(4096, bool))
    assert np.asarray(miss).mean() < 0.2


def test_fp_engine_bloom_on_off_equal(world):
    """gcount/ucount identical with the bloom gate enabled and disabled."""
    import os

    rec, kmap, parent, tax, packed = world
    records = make_reads(kmap, n=250, read_len=90)
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)
    results = {}
    for flag in ("1", "0"):
        os.environ["KMER_BLOOM"] = flag
        try:
            cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=64, max_len=96)
            clf = FpClassifier(packed, tax, batch_size=64, max_len=96)
            sp = SampleProcessor(clf, cfg)
            sp.feed(records)
            res = sp.finish()
            results[flag] = (res.gcount.tolist(), res.ucount.tolist())
        finally:
            os.environ.pop("KMER_BLOOM", None)
    assert results["1"] == results["0"]
    assert results["1"][0] == sim.gcount and results["1"][1] == sim.ucount


def test_fp_engine_bloom_dense_fallback(world, monkeypatch):
    """Reads passing more bloom windows than BLOOM_K flip the batch to the
    probe-every-window path; results stay exact."""
    import jax

    from kmer_id_tpu.engine import fpclassify as F

    rec, kmap, parent, tax, packed = world
    keys = list(kmap)
    records = make_reads(kmap, n=20, read_len=90)
    seq = "".join(
        codec.key_to_string(keys[int(rng.integers(len(keys)))]) for _ in range(6)
    )
    records.insert(2, ("dense", seq, None))  # 6 probe windows > BLOOM_K=3
    sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
    sim.feed(records)
    monkeypatch.setattr(F, "BLOOM_K", 3)
    jax.clear_caches()
    try:
        cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=32, max_len=192)
        clf = FpClassifier(packed, tax, batch_size=32, max_len=192)
        sp = SampleProcessor(clf, cfg)
        sp.feed(records)
        res = sp.finish()
        assert res.gcount.tolist() == sim.gcount
        assert res.ucount.tolist() == sim.ucount
    finally:
        jax.clear_caches()


def test_fp_engine_two_tier_boundary(world):
    """A read whose candidate count lands between FAST_HITS and max_hits
    flips the batch-level cond to the full-width tier (engine/fpclassify.py
    _compact_verify); results must match the reference simulator exactly,
    and an all-small batch (fast tier) must too."""
    rec, kmap, parent, tax, packed = world
    keys = list(kmap)
    for with_big in (False, True):
        records = make_reads(kmap, n=30, read_len=90)
        if with_big:
            # ~12 back-to-back probe 30-mers: > FAST_HITS=8, <= max_hits=32
            seq = "".join(
                codec.key_to_string(keys[int(rng.integers(len(keys)))])
                for _ in range(12)
            )
            records.insert(3, ("big", seq, None))
        sim = RefSim(kmap, parent, num_targ=8, u_is_t=False)
        sim.feed(records)
        cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=32, max_len=384)
        clf = FpClassifier(packed, tax, batch_size=32, max_len=384, max_hits=32)
        sp = SampleProcessor(clf, cfg)
        sp.feed(records)
        res = sp.finish()
        assert res.gcount.tolist() == sim.gcount, f"with_big={with_big}"
        assert res.ucount.tolist() == sim.ucount, f"with_big={with_big}"


def test_fp_engine_beyond_legacy_slot_cap():
    """Production-scale guard: a DB whose slot table exceeds 2^22 slots (an
    earlier int32 packing cap) classifies correctly on the flagship path.

    5M probes -> nb 2^20 -> 2^23 slots; cross-checked against the legacy
    sorted-array engine (golden-tested elsewhere) on planted-probe reads.
    """
    from kmer_id_tpu.db.probes import PackedDB
    from kmer_id_tpu.engine.classify import Classifier

    n = 5_000_000
    r = np.random.default_rng(42)
    raw = r.integers(0, 1 << 60, size=int(n * 1.05), dtype=np.uint64)
    # canonicalize so planted key strings re-encode to themselves
    rc = np.zeros_like(raw)
    k = raw.copy()
    for _ in range(codec.KSIZE):
        rc = (rc << np.uint64(2)) | ((np.uint64(3) - (k & np.uint64(3))) & np.uint64(3))
        k >>= np.uint64(2)
    keys = np.unique(np.minimum(raw, rc))[:n]
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    num_targ = 64
    targets = r.integers(2, num_targ, size=n).astype(np.int32)
    packed = PackedDB(
        keys=keys, hi=hi, lo=lo, target=targets,
        org=np.zeros(n, np.int32), position=np.zeros(n, np.int32),
        fstrand=np.ones(n, bool), num_targ=num_targ,
    )
    tax = Taxonomy.from_edges(
        [(1, t) for t in range(2, num_targ)], num_nodes=num_targ
    )
    fp_clf = FpClassifier(packed, tax, batch_size=256, max_len=128)
    assert fp_clf.fpdb.n_slots > (1 << 22)
    legacy = Classifier(packed, tax, batch_size=256, max_len=128)

    records = []
    for i in range(512):
        seq = rand_dna(150)
        for _ in range(int(r.integers(0, 4))):
            kidx = int(r.integers(n))
            pos = int(r.integers(0, 150 - codec.KSIZE))
            seq = seq[:pos] + codec.key_to_string(keys[kidx]) + seq[pos + codec.KSIZE:]
        records.append((f"r{i}", seq, None))

    cfg = ClassifyConfig.preset("nx", num_targ=num_targ, batch_size=256, max_len=128)
    results = []
    for clf in (fp_clf, legacy):
        sp = SampleProcessor(clf, cfg)
        sp.feed(records)
        results.append(sp.finish())
    assert results[0].gcount.tolist() == results[1].gcount.tolist()
    assert results[0].ucount.tolist() == results[1].ucount.tolist()
    assert results[0].gcount[2:].sum() > 150  # planted probes actually hit


@pytest.mark.parametrize("num_targ,n,dense", [
    (5982, 100_001, False),
    (17227, 1 << 16, False),
    (130, 7, False),
    # one target owning more than 2^24 set slots: past float32's exact
    # integer range, exact in the int32 scatter-add
    (64, (1 << 24) + 5, True),
])
def test_ucount_exact(num_targ, n, dense):
    """The ucount finalize (engine/fpclassify._ucount_device) equals a host
    bincount, including empty/padded tails, targets 0/1 (never counted) and
    counts past 2^24."""
    from kmer_id_tpu.engine.fpclassify import _ucount_device

    r = np.random.default_rng(11)
    if dense:
        node = np.full(n, 7, np.int32)
        node[:1000] = r.integers(0, num_targ, size=1000)
        seen = np.ones(n, np.int8)
        seen[::97] = 0
    else:
        node = r.integers(0, num_targ, size=n).astype(np.int32)
        seen = (r.random(n) < 0.3).astype(np.int8)
    m = (seen > 0) & (node > 1)
    want = np.bincount(node[m], minlength=num_targ)
    got = np.asarray(_ucount_device(seen, node, num_targ=num_targ))
    assert got.dtype == np.int32
    assert (got == want).all()
