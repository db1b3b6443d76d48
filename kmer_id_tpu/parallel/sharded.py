"""Sharded classification: data-parallel reads × key-range-sharded DB.

SPMD design (shard_map over a (data, db) mesh):

* the sorted probe arrays are padded to ``db_shards × shard_len`` with
  all-ones sentinel keys (> any 60-bit key) and split contiguously, so each
  ``db`` shard owns one key *range* — a query resolves on exactly one shard;
* read batches shard across ``data`` and are replicated across ``db``; each
  device binary-searches its local range, and per-window targets combine
  with a single ``psum`` over ``db`` (all non-owners contribute 0) — the only
  collective in the hot path;
* the ordered MSCA fold then runs identically on every ``db`` member (cheap,
  keeps the final per-read calls replicated), and the ``seen`` bitmap stays
  aligned with the local key range, so unique-k-mer accounting needs no
  communication until the per-sample finalize.

Exactness: counts/final calls are bit-identical to the single-device engine
(verified in tests/test_sharding.py on an 8-way virtual CPU mesh), because
key ownership is a partition and the fold consumes the same target sequence.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmer_id_tpu.core.codec import KSIZE
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.probes import PackedDB
from kmer_id_tpu.io.batch import Batch, LongRead
from kmer_id_tpu.ops.extract import extract_kmers
from kmer_id_tpu.ops.fold import compact_hits
from kmer_id_tpu.ops.lookup import lookup_keys
from kmer_id_tpu.engine.classify import fold_host, resolve_finals


from dataclasses import dataclass


@dataclass
class _ShardedPending:
    packed: object
    codes: object
    lengths: object
    n_rows: int


class ShardedClassifier:
    """Drop-in for engine.Classifier, spread over a (data, db) mesh."""

    def __init__(
        self,
        db: PackedDB,
        taxonomy: Taxonomy,
        mesh: Mesh,
        batch_size: int = 1024,
        max_len: int = 512,
    ):
        if len(db) == 0:
            raise ValueError("cannot classify against an empty probe DB")
        self.mesh = mesh
        self.dp = mesh.shape["data"]
        self.dbp = mesh.shape["db"]
        if batch_size % self.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by data={self.dp}")
        self.batch_size = batch_size
        self.max_len = max_len
        self.taxonomy = taxonomy
        self.num_targ = db.num_targ
        self.n_probes = len(db)
        self.db_target_host = np.asarray(db.target)

        # pad the sorted key plane to dbp equal ranges with +inf sentinels
        ln = -(-len(db) // self.dbp)
        pad = ln * self.dbp - len(db)
        self.shard_len = ln

        def padded(a, fill):
            return np.concatenate([np.asarray(a), np.full(pad, fill, a.dtype)])

        hi = padded(db.hi, np.uint32(0xFFFFFFFF))
        lo = padded(db.lo, np.uint32(0xFFFFFFFF))
        tg = padded(db.target.astype(np.int32), 0)
        sh = NamedSharding(mesh, P("db"))
        self._db_hi = jax.device_put(hi, sh)
        self._db_lo = jax.device_put(lo, sh)
        self._db_tgt = jax.device_put(tg, sh)
        rep = NamedSharding(mesh, P())
        self._anc = jax.device_put(taxonomy.anc, rep)
        self._depth = jax.device_put(taxonomy.depth, rep)
        self._data_sh = NamedSharding(mesh, P("data"))
        self._seen_sh = NamedSharding(mesh, P("data", "db"))

        ispec = (
            P("db"), P("db"), P("db"),  # db planes
            P("data", "db"),  # seen
            P("data", None), P("data"),  # codes, lengths
            P(None, None), P(None),  # anc, depth
        )

        def step(db_hi, db_lo, db_tgt, seen, codes, lengths, anc, depth, mode):
            ex = extract_kmers(codes, lengths)
            idx, found = lookup_keys({"hi": db_hi, "lo": db_lo}, ex["hi"], ex["lo"])
            found = found & ex["valid"]
            nloc = db_hi.shape[0]
            tgt_local = jnp.where(
                found, jnp.take(db_tgt, jnp.minimum(idx, nloc - 1), axis=0), 0
            ).astype(jnp.int32)
            tgt = jax.lax.psum(tgt_local, "db")
            scat = jnp.where(found & (tgt_local > 1), idx, nloc).reshape(-1)
            seen = seen.at[0, 0, scat].set(1, mode="promise_in_bounds")
            if mode == "compact":
                out = compact_hits(anc, depth, tgt, 32)
            else:
                out = tgt
            return seen, out

        def build(mode):
            fn = shard_map(
                partial(step, mode=mode),
                mesh=mesh,
                in_specs=ispec,
                out_specs=(P("data", "db", None), P("data")),
                check_vma=False,
            )
            return jax.jit(fn, donate_argnums=(3,))

        self._step_fold = build("compact")
        self._step_scan = build("targets")

    # ------------------------------------------------------------ API
    def new_seen(self) -> jax.Array:
        return jax.device_put(
            jnp.zeros((self.dp, self.dbp, self.shard_len + 1), jnp.int8), self._seen_sh
        )

    def _call(self, fn, seen, codes, lengths):
        codes = jax.device_put(jnp.asarray(codes), self._data_sh)
        lengths = jax.device_put(jnp.asarray(lengths), self._data_sh)
        return fn(
            self._db_hi, self._db_lo, self._db_tgt, seen, codes, lengths,
            self._anc, self._depth,
        )

    def submit_batch(self, seen, batch: Batch):
        seen, packed = self._call(self._step_fold, seen, batch.codes, batch.lengths)
        return seen, _ShardedPending(packed, batch.codes, batch.lengths, batch.n_rows)

    def collect(self, seen, pending):
        def get_targets():
            nonlocal seen
            seen, tgt = self._call(
                self._step_scan, seen, pending.codes, pending.lengths
            )
            return tgt

        finals = resolve_finals(self.taxonomy, pending.packed, get_targets)
        return seen, finals[: pending.n_rows]

    def process_batch(self, seen, batch: Batch):
        seen, pending = self.submit_batch(seen, batch)
        return self.collect(seen, pending)

    def process_long(self, seen, item: LongRead):
        codes = item.codes
        tl = len(codes)
        l = self.max_len
        step = l - KSIZE + 1
        w = tl - KSIZE + 1
        starts = list(range(0, w, step))
        parts: list[np.ndarray] = []
        for g in range(0, len(starts), self.batch_size):
            group = starts[g : g + self.batch_size]
            plane = np.full((self.batch_size, l), 4, dtype=np.uint8)
            lengths = np.zeros(self.batch_size, dtype=np.int32)
            for r, s in enumerate(group):
                chunk = codes[s : s + l]
                plane[r, : len(chunk)] = chunk
                lengths[r] = len(chunk)
            seen, tgt = self._call(self._step_scan, seen, plane, lengths)
            tgt = np.asarray(tgt)
            for r, s in enumerate(group):
                parts.append(tgt[r, : min(step, w - s)])
        targets = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        return seen, fold_host(self.taxonomy, targets)

    def ucount(self, seen) -> np.ndarray:
        s = np.asarray(seen)  # [dp, dbp, ln+1]
        merged = s.any(axis=0)[:, : self.shard_len].reshape(-1)[: self.n_probes]
        t = self.db_target_host[merged]
        t = t[t > 1]
        return np.bincount(t, minlength=self.num_targ).astype(np.int64)
