"""Single-device classification engine.

Per batch (one jit-compiled XLA program, static [B, L] shape):

    codes [B,L] ──extract──► (hi,lo) keys [B,P] ──binary-search──► idx/found
        ──gather──► per-window targets ──ordered scan──► final target [B]
        └──scatter──► `seen` probe bitmap (unique-k-mer accounting)

vs the reference's per-read/per-base interpreter loop
(``newkmer_10nx.cpp:452-617``).  Parity-relevant behaviors preserved:

* per-window hit fold is the *ordered* ``msca`` fold (ops/fold.py);
* ``ucount[t]`` = number of distinct present DB k-mers with target ``t > 1``
  (``newkmer_10nx.cpp:596-603``): the per-sample ``set<ktype>`` becomes a
  per-sample `seen` bitmap over DB slots — exact, because DB keys are unique
  and each k-mer has exactly one DB target, and order-free;
* ``gcount`` stays host-side (the per-read finals return to the host anyway
  for the saved-read capture files and concordance checks).

Long reads (> max_len) stream through the same kernel as chunk rows with a
KSIZE-1 halo; their window-target sequence is reassembled host-side and folded
exactly (fast path: if every hit is an ancestor-or-self of the deepest hit,
the hits lie on one root chain and the fold is order-free = that deepest hit;
otherwise the rare order-dependent case runs the literal sequential fold).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmer_id_tpu.core.codec import KSIZE
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.probes import PackedDB
from kmer_id_tpu.io.batch import Batch, LongRead
from kmer_id_tpu.ops.extract import extract_kmers
from kmer_id_tpu.ops.fold import compact_hits, fold_targets
from kmer_id_tpu.ops.lookup import cuckoo_lookup, lookup_keys


def classify_core(seen, db, tax, codes, lengths, bucket_bits: int, mode: str,
                  max_hits: int = 32, max_steps: int | None = None):
    """Un-jitted kernel core, shared by the single-device engine, the
    sharded engine (inside shard_map), and the graft entry point.

    mode "compact": returns per-read hit summaries (scan-free; see
    ops.fold.compact_hits) resolved to final calls host-side.
    mode "targets": returns the raw [B, P] per-window target plane (used by
    the long-read path and the overflow fallback).
    """
    ex = extract_kmers(codes, lengths)
    if "cuckoo" in db:
        tgt0, idx, found = cuckoo_lookup(db, ex["hi"], ex["lo"])
        n = db["n_probes"]  # traced scalar; used only as the miss sentinel
    else:
        idx, found = lookup_keys(
            db, ex["hi"], ex["lo"], bucket_bits=bucket_bits, max_steps=max_steps
        )
        tgt0 = None
        n = db["hi"].shape[0]
    found = found & ex["valid"]
    if mode == "detail":
        # verification replay (engine/verify.py): per-window hit index with
        # the read-strand sign, plus key words; no seen scatter (unique-kmer
        # accounting moves host-side because rejected hits must not count)
        sign = jnp.where(ex["fstrand"], 1, -1).astype(jnp.int32)
        detail = jnp.where(found, (idx + 1) * sign, 0)
        return seen, (detail, ex["hi"], ex["lo"])
    if tgt0 is not None:
        tgt = jnp.where(found, tgt0, 0)
    else:
        safe = jnp.minimum(idx, max(n - 1, 0))
        tgt = jnp.where(found, jnp.take(db["target"], safe, axis=0), 0).astype(
            jnp.int32
        )
    scat = jnp.where(found & (tgt > 1), idx, n).reshape(-1)
    seen = seen.at[scat].set(1, mode="promise_in_bounds")
    if mode == "compact":
        return seen, compact_hits(tax["anc"], tax["depth"], tgt, max_hits)
    return seen, tgt


@partial(jax.jit, static_argnames=("bucket_bits", "mode", "max_hits", "max_steps"),
         donate_argnums=(0,))
def _classify_kernel(seen, db, tax, codes, lengths, bucket_bits: int, mode: str,
                     max_hits: int = 32, max_steps: int | None = None):
    return classify_core(
        seen, db, tax, codes, lengths, bucket_bits, mode, max_hits, max_steps
    )


@dataclass
class PendingBatch:
    """In-flight device work for one batch."""

    packed: object  # device [B, max_hits+3] i32 summary
    codes: object
    lengths: object
    n_rows: int


def resolve_finals(tax, summary, get_targets) -> np.ndarray:
    """Resolve per-read final calls from a device hit summary, exactly.

    ``summary`` is the packed [B, max_hits+3] i32 plane from
    ops.fold.compact_hits (cols: deepest, nhits, consistent, hits...).

    * no hits -> 0; consistent -> deepest (order-free, proven in
      ops.fold.compact_hits);
    * inconsistent with nhits <= max_hits -> sequential msca fold of the
      compacted in-order hit list (newkmer_10nx.cpp:588-595);
    * inconsistent overflow (rare) -> re-derive the full target plane via
      ``get_targets()`` and fold it.
    """
    packed = np.asarray(summary)
    deepest = packed[:, 0]
    nhits = packed[:, 1]
    consistent = packed[:, 2] != 0
    hits = packed[:, 3:]
    b, h = hits.shape
    finals = np.where(nhits == 0, 0, deepest).astype(np.int32)
    todo = np.nonzero(~consistent & (nhits > 0) & (nhits <= h))[0]
    if len(todo):
        # fold all inconsistent rows step-synchronously: one vectorized msca
        # per hit slot instead of a Python loop per read
        sub = hits[todo]
        cur = np.zeros(len(todo), dtype=np.int32)
        for k in range(int(nhits[todo].max())):
            t = sub[:, k]
            live = t > 0
            merged = tax.msca(t, np.maximum(cur, 1))
            cur = np.where(live, np.where(cur > 0, merged, t), cur)
        finals[todo] = cur
    overflow = np.nonzero(~consistent & (nhits > h))[0]
    if len(overflow):
        full = np.asarray(get_targets())
        for r in overflow:
            seq = full[r][full[r] > 0]
            final = 0
            for t in seq.tolist():
                final = int(tax.msca(t, final)) if final > 0 else t
            finals[r] = final
    return finals


def fold_host_many(tax, seqs: list) -> np.ndarray:
    """Exact ordered msca fold of MANY reads' hit sequences, batched.

    The fold is sequential along each read's hits but independent across
    reads, so it runs as max_hits column steps of the ALREADY-vectorized
    ``tax.msca`` over the whole batch — the long-read lane folds ~1000
    genome contigs in ~20 vectorized steps instead of ~20,000 scalar msca
    calls.
    """
    r = len(seqs)
    out = np.zeros(r, dtype=np.int64)
    if r == 0:
        return out
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    h = int(lens.max(initial=0))
    if h == 0:
        return out
    plane = np.zeros((r, h), dtype=np.int64)
    for i, s in enumerate(seqs):
        plane[i, : len(s)] = s
    f = np.zeros(r, dtype=np.int64)
    for col in range(h):
        t = plane[:, col]
        use = t > 0
        if not use.any():
            continue
        merged = tax.msca(t, f)
        f = np.where(use, np.where(f > 0, merged, t), f)
    return f


def fold_host(tax, targets: np.ndarray) -> int:
    """Exact host-side ordered fold of an in-order window-target sequence.

    Fast path: if every hit is an ancestor-or-self of the deepest hit, the
    hit set lies on one root chain and the fold is order-free (= that
    deepest hit); otherwise run the literal sequential msca fold
    (newkmer_10nx.cpp:588-595) — the rare order-dependent case.
    """
    hits = targets[targets > 0]
    if hits.size == 0:
        return 0
    deepest = int(hits[int(np.argmax(tax.depth[hits]))])
    if bool(np.all(tax.is_anc_or_self(hits, deepest))):
        return deepest
    final = 0
    for t in hits.tolist():
        final = int(tax.msca(t, final)) if final > 0 else t
    return final


class Classifier:
    """Holds device-resident DB/taxonomy arrays and drives the jitted step."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        batch_size: int = 1024,
        max_len: int = 512,
        use_cuckoo: bool = True,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.n_probes = len(db)
        self.num_targ = db.num_targ
        self.bucket_bits = db.bucket_bits
        import math as _math

        self.max_steps = (
            max(1, _math.ceil(_math.log2(db.max_bucket_len + 1)))
            if db.bucket_bits > 0 and db.max_bucket_len > 0
            else None
        )
        self.batch_size = batch_size
        self.max_len = max_len
        self.max_hits = 32
        self.taxonomy = taxonomy
        self.packed_db = db
        self.db_target_host = np.asarray(db.target)
        self._db = {
            "hi": jnp.asarray(np.asarray(db.hi)),
            "lo": jnp.asarray(np.asarray(db.lo)),
            "target": jnp.asarray(np.asarray(db.target, dtype=np.int32)),
        }
        if db.bucket_bits > 0:
            self._db["bucket_off"] = jnp.asarray(np.asarray(db.bucket_off))
        if use_cuckoo:
            ck = db.cuckoo()
            self._db = {
                "cuckoo": jnp.asarray(ck.table),
                "n_probes": jnp.int32(self.n_probes),
                "cuckoo_s1": jnp.uint32(ck.s1),
                "cuckoo_s2": jnp.uint32(ck.s2),
                "target": self._db["target"],
            }
        self._tax = {
            "anc": jnp.asarray(taxonomy.anc),
            "depth": jnp.asarray(taxonomy.depth),
        }

    # ------------------------------------------------------------ state
    def new_seen(self) -> jax.Array:
        """Per-sample probe bitmap; slot n_probes is the miss sink."""
        return jnp.zeros(self.n_probes + 1, dtype=jnp.int8)

    # ------------------------------------------------------------ steps
    def submit_batch(self, seen, batch: Batch):
        """Enqueue one batch on the device; returns (seen', PendingBatch).

        Asynchronous by design: the sample loop keeps several batches in
        flight and collects results later, so host decode overlaps device
        work and transfers.
        """
        codes = jnp.asarray(batch.codes)
        lengths = jnp.asarray(batch.lengths)
        seen, packed = _classify_kernel(
            seen, self._db, self._tax, codes, lengths,
            bucket_bits=self.bucket_bits, mode="compact",
            max_hits=self.max_hits, max_steps=self.max_steps,
        )
        try:
            packed.copy_to_host_async()  # overlap D2H with later batches
        except AttributeError:
            pass
        return seen, PendingBatch(packed, codes, lengths, batch.n_rows)

    def collect(self, seen, pending: "PendingBatch"):
        """Resolve a pending batch to host finals; returns (seen', finals)."""

        def get_targets():
            # overflow fallback: re-derive the full target plane (the repeat
            # seen-scatter is idempotent, so collecting after later
            # submissions is safe)
            nonlocal seen
            seen, tgt = _classify_kernel(
                seen, self._db, self._tax, pending.codes, pending.lengths,
                bucket_bits=self.bucket_bits, mode="targets",
                max_steps=self.max_steps,
            )
            return tgt

        finals = resolve_finals(self.taxonomy, pending.packed, get_targets)
        return seen, finals[: pending.n_rows]

    def process_batch(self, seen, batch: Batch):
        """Submit + collect (synchronous convenience path)."""
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def detail_batch(self, seen, batch: Batch):
        """Per-window hit detail for the verification replay path."""
        seen, (detail, hi, lo) = _classify_kernel(
            seen, self._db, self._tax,
            jnp.asarray(batch.codes), jnp.asarray(batch.lengths),
            bucket_bits=self.bucket_bits, mode="detail",
            max_steps=self.max_steps,
        )
        keys = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo)
        return seen, np.asarray(detail), keys

    def process_long(self, seen, item: LongRead):
        """Classify one read longer than max_len; returns (seen', final)."""
        codes = item.codes
        tl = len(codes)
        l = self.max_len
        step = l - KSIZE + 1
        w = tl - KSIZE + 1
        starts = list(range(0, w, step))
        hits_parts: list[np.ndarray] = []
        for g in range(0, len(starts), self.batch_size):
            group = starts[g : g + self.batch_size]
            plane = np.full((self.batch_size, l), 4, dtype=np.uint8)
            lengths = np.zeros(self.batch_size, dtype=np.int32)
            for r, s in enumerate(group):
                chunk = codes[s : s + l]
                plane[r, : len(chunk)] = chunk
                lengths[r] = len(chunk)
            seen, tgt = _classify_kernel(
                seen,
                self._db,
                self._tax,
                jnp.asarray(plane),
                jnp.asarray(lengths),
                bucket_bits=self.bucket_bits,
                mode="targets",
            )
            tgt = np.asarray(tgt)
            for r, s in enumerate(group):
                hits_parts.append(tgt[r, : min(step, w - s)])
        targets = np.concatenate(hits_parts) if hits_parts else np.zeros(0, np.int32)
        return seen, self._fold_host(targets)

    def _fold_host(self, targets: np.ndarray) -> int:
        return fold_host(self.taxonomy, targets)

    # ------------------------------------------------------------ finalize
    def ucount(self, seen) -> np.ndarray:
        """Per-target distinct-present-k-mer counts from the seen bitmap."""
        seen_h = np.asarray(seen)[: self.n_probes].astype(bool)
        t = self.db_target_host[seen_h]
        t = t[t > 1]
        return np.bincount(t, minlength=self.num_targ).astype(np.int64)
