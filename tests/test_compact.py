"""ops/compact.py: the three compaction formulations are bit-identical.

The engine's candidate compaction must reproduce the reference's discovery
order exactly — ascending window position, ties in plane order
(newkmer_10nx.cpp:529-603 probes each window once; our planes are mutually
exclusive for true hits but false fingerprint candidates can co-occur).
These tests pin compact_ranks (jnp) and compact_sort (the sort oracle) to
identical outputs, and the engine paths to identical finals whichever
formulation is selected.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kmer_id_tpu.ops.compact import (
    _SENT,
    compact_auto,
    compact_ranks,
    compact_sort,
    interleave_planes,
)


def _fixture(rng, b, p, k, density):
    cand = [
        jnp.asarray(rng.integers(0, 2**31 - 1, size=(b, p), dtype=np.int32))
        for _ in range(k)
    ]
    valid = [jnp.asarray(rng.random((b, p)) < density) for _ in range(k)]
    planes = list(zip(cand, valid))
    cand_ilv, valid_ilv = interleave_planes(planes)
    pos_ilv = jax.lax.broadcasted_iota(jnp.int32, (1, p * k), 1) // k
    return cand_ilv, valid_ilv, pos_ilv


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
@pytest.mark.parametrize("max_hits", [4, 32])
def test_reduce_matches_sort(density, max_hits):
    rng = np.random.default_rng(42)
    args = _fixture(rng, 64, 37, 3, density) + (max_hits,)
    got = compact_ranks(*args)
    want = compact_sort(*args)
    for g, w, name in zip(got[:3], want[:3], ("pos", "cand", "ncand")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("b,p", [(8, 37), (64, 131)])
def test_compact_auto_is_fixed_rank_form(b, p):
    """The engines' entry point is the jnp rank form, chosen in code: no
    kernel probe, no fallback, the same result on every backend; its
    payload planes (incl. uint32 key words) match the sort oracle."""
    from kmer_id_tpu.ops import compact

    assert not hasattr(compact, "pallas_available")
    rng = np.random.default_rng(7)
    cand_ilv, valid_ilv, pos_ilv = _fixture(rng, b, p, 3, 0.05)
    ex = (cand_ilv + 1, (cand_ilv * 3).astype(jnp.uint32))
    got = compact_auto(cand_ilv, valid_ilv, pos_ilv, 8, extras=ex)
    want = compact_ranks(cand_ilv, valid_ilv, pos_ilv, 8, extras=ex)
    oracle = compact_sort(cand_ilv, valid_ilv, pos_ilv, 8, extras=ex)
    for g, w, o, name in zip(
        got[:3] + got[3], want[:3] + want[3], oracle[:3] + oracle[3],
        ("pos", "cand", "ncand", "ex0", "ex1"),
    ):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(o), err_msg=name)
        assert np.asarray(g).dtype == np.asarray(o).dtype


def test_window_order_with_cross_plane_ties():
    """A window with candidates in multiple planes keeps plane order."""
    b, p, k = 1, 5, 3
    cand = np.zeros((b, p, k), np.int32)
    valid = np.zeros((b, p, k), bool)
    # window 1: plane0 + plane2; window 3: plane1
    cand[0, 1, 0], cand[0, 1, 2], cand[0, 3, 1] = 10, 12, 31
    valid[0, 1, 0] = valid[0, 1, 2] = valid[0, 3, 1] = True
    planes = [(jnp.asarray(cand[:, :, i]), jnp.asarray(valid[:, :, i])) for i in range(k)]
    ci, vi = interleave_planes(planes)
    pos_ilv = jax.lax.broadcasted_iota(jnp.int32, (1, p * k), 1) // k
    pos32, cand32, ncand, _ = compact_ranks(ci, vi, pos_ilv, 4)
    assert list(np.asarray(cand32)[0, :3]) == [10, 12, 31]
    assert list(np.asarray(pos32)[0, :3]) == [1, 1, 3]
    assert int(ncand[0]) == 3
    assert int(np.asarray(pos32)[0, 3]) == _SENT


def test_engine_equal_under_all_formulations(monkeypatch):
    """fp engine gcount/ucount are identical under sort and reduce compaction
    (the selection is trace-time, so clear jit caches between runs)."""
    from kmer_id_tpu.ops import compact
    from kmer_id_tpu.config import ClassifyConfig
    from kmer_id_tpu.core.taxonomy import Taxonomy
    from kmer_id_tpu.db.probes import pack_probes
    from kmer_id_tpu.engine.fpclassify import FpClassifier
    from kmer_id_tpu.engine.pipeline import SampleProcessor
    from tests.test_classify_e2e import make_db, make_reads

    rec, kmap = make_db()
    parent = [1] * 8
    parent[3] = parent[4] = 2
    parent[5] = 4
    parent[6] = 1
    parent[7] = 6
    tax = Taxonomy(np.array(parent, dtype=np.int32))
    packed = pack_probes(rec, num_targ=8)
    records = make_reads(kmap, n=200, read_len=90)

    results = {}
    impls = {"sort": compact.compact_sort, "reduce": compact.compact_ranks}
    for impl, fn in impls.items():
        monkeypatch.setattr(compact, "compact_auto", fn)
        jax.clear_caches()
        cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=32, max_len=96)
        clf = FpClassifier(packed, tax, batch_size=32, max_len=96, max_hits=8)
        sp = SampleProcessor(clf, cfg)
        sp.feed(records)
        res = sp.finish()
        results[impl] = (res.gcount.copy(), res.ucount.copy())
    np.testing.assert_array_equal(results["sort"][0], results["reduce"][0])
    np.testing.assert_array_equal(results["sort"][1], results["reduce"][1])
    monkeypatch.undo()
    jax.clear_caches()
