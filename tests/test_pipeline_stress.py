"""Collector-thread pipeline stress.

The SampleProcessor overlaps device submits (main thread) with collects +
accounting (one collector worker) through a FIFO of futures, with two
seen-bitmap donation chains that must never cross threads
(engine/pipeline.py).  This test hammers that design deterministically:
deep pipeline, interleaved long reads and candidate-overflow reads, an
artificially slowed collect, 20 repetitions — every rep must produce
byte-identical gcount/ucount/reads-capture vs the serialized (depth-0)
pipeline.  Account order is checked through the order-dependent
first-SAVENUM saved-reads capture (newkmer_10nx.cpp:608-612).
"""

import io
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from kmer_id_tpu.config import ClassifyConfig  # noqa: E402
from kmer_id_tpu.core import codec  # noqa: E402
from kmer_id_tpu.core.taxonomy import Taxonomy  # noqa: E402
from kmer_id_tpu.db.probes import pack_probes  # noqa: E402
from kmer_id_tpu.engine.fpclassify import FpClassifier  # noqa: E402
from kmer_id_tpu.engine.pipeline import SampleProcessor  # noqa: E402
from tests.test_classify_e2e import make_db, make_reads, rand_dna  # noqa: E402


class SlowCollect:
    """Engine proxy that delays collect/long-read resolution by a
    deterministic per-call amount — widens the submit/collect race window."""

    def __init__(self, clf, delays_ms=(0, 12, 3, 7)):
        self._clf = clf
        self._delays = delays_ms
        self._n = 0

    def __getattr__(self, name):
        return getattr(self._clf, name)

    def collect(self, seen, pending):
        time.sleep(self._delays[self._n % len(self._delays)] / 1000.0)
        self._n += 1
        return self._clf.collect(seen, pending)

    def process_long_many(self, seen, items):
        time.sleep(self._delays[self._n % len(self._delays)] / 1000.0)
        self._n += 1
        return self._clf.process_long_many(seen, items)


def _records(kmap):
    """~200 normal reads + interleaved long reads + overflow-dense reads."""
    recs = make_reads(kmap, n=200, read_len=80)
    keys = list(kmap)
    out = []
    for i, r in enumerate(recs):
        out.append(r)
        if i % 23 == 11:  # long read (> max_len): chunked lane
            parts = []
            for j in range(4):
                parts.append(rand_dna(140))
                parts.append(codec.key_to_string(keys[(i + j * 5) % len(keys)]))
            out.append((f"L{i}", "".join(parts), None))
        if i % 31 == 7:  # hit-dense read: candidate overflow -> host replay
            seq = "".join(
                codec.key_to_string(keys[(i * 3 + j) % len(keys)]) for j in range(12)
            )
            out.append((f"D{i}", seq, None))
    return out


def _run(clf, cfg, records, depth):
    sp = SampleProcessor(clf, cfg, reads_out=io.StringIO(), use_native=False)
    sp.pipeline_depth = depth
    # feed in small chunks so submits and collects interleave heavily
    for s in range(0, len(records), 17):
        sp.feed(records[s : s + 17])
    res = sp.finish()
    return res, sp


def test_collector_pipeline_deterministic_under_stress():
    rec, kmap = make_db(num_targ=8, probes_per_target=40)
    tax = Taxonomy(np.array([1, 1, 1, 2, 2, 4, 1, 6], np.int32))
    packed = pack_probes(rec, num_targ=8)
    records = _records(kmap)
    cfg = ClassifyConfig.preset("nx", num_targ=8, batch_size=16, max_len=96)

    base_clf = FpClassifier(packed, tax, batch_size=16, max_len=96, max_hits=8)
    ref_res, ref_sp = _run(base_clf, cfg, records, depth=0)
    ref_reads = ref_sp.reads_out.getvalue()
    assert ref_res.reads == len(records)
    assert len(ref_reads) > 0  # capture is actually exercised

    for rep in range(20):
        clf = SlowCollect(base_clf, delays_ms=(rep % 5, 11, 0, (rep * 3) % 17))
        res, sp = _run(clf, cfg, records, depth=4 + rep % 4)
        assert res.gcount.tolist() == ref_res.gcount.tolist(), rep
        assert res.ucount.tolist() == ref_res.ucount.tolist(), rep
        assert res.reads == ref_res.reads, rep
        assert sp.reads_out.getvalue() == ref_reads, rep
