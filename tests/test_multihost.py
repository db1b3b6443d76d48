"""Multi-host wiring: 2-process jax.distributed on localhost CPU.

The reference is strictly single-process; this framework scales across
hosts with ``jax.distributed`` (SURVEY.md §2.4).  This test launches
two real processes that form one 4-device global CPU mesh, run a psum over
the real mesh, and split classification work via the file-locked
SampleQueue — verifying the wiring the CLI flags
(``--coordinator/--num-processes/--process-id``) feed.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, %(root)r)
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
from kmer_id_tpu.parallel.distributed import initialize, SampleQueue, health_check
initialize(coordinator=%(coord)r, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
h = health_check()
assert h["ok"] and len(h["devices"]) == 2, h
assert h["barrier_s"] is not None  # cross-process psum barrier ran

# a psum over the full cross-process mesh
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
def f(x):
    return jax.lax.psum(x, "data")
g = jax.jit(shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=P()))
x = jax.device_put(np.arange(8, dtype=np.int32), NamedSharding(mesh, P("data")))
got = np.asarray(g(x))
want = np.arange(8, dtype=np.int32).reshape(4, 2).sum(axis=0)
assert (got == want).all(), (got, want)

# cross-process work split via the file-locked sample queue
q = SampleQueue(os.path.join(%(qdir)r, "manifest.json"), [f"s{i}" for i in range(8)])
mine = []
while True:
    s = q.claim(f"proc{pid}")
    if s is None:
        break
    mine.append(s)
    q.complete(s)
print(json.dumps({"pid": pid, "claimed": mine}))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_mesh_and_queue(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    qdir = str(tmp_path)
    script = _WORKER % {"root": ROOT, "coord": coord, "qdir": qdir}
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=220)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    claimed = sorted(outs[0]["claimed"] + outs[1]["claimed"])
    assert claimed == [f"s{i}" for i in range(8)], claimed  # each sample once


_CLF_WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, %(root)r)
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
from kmer_id_tpu.parallel.distributed import initialize
initialize(coordinator=%(coord)r, num_processes=2, process_id=pid)
assert jax.process_count() == 2 and jax.device_count() == 4

import numpy as np
from tests.test_classify_e2e import make_db, make_reads
from kmer_id_tpu.core import codec
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.fpdb import build_fpdb
from kmer_id_tpu.db.probes import pack_probes
from kmer_id_tpu.engine.fpclassify import FpClassifier
from kmer_id_tpu.io.batch import Batch
from kmer_id_tpu.parallel import make_mesh
from kmer_id_tpu.parallel.fpsharded import ShardedFpClassifier

# identical deterministic world in both processes (module rng seeds)
rec, kmap = make_db(num_targ=8, probes_per_target=40)
tax = Taxonomy(np.array([1, 1, 1, 2, 2, 4, 1, 6], np.int32))
packed = pack_probes(rec, num_targ=8)
fp = build_fpdb(packed, tax)

B, L, MH = 64, 512, 8
records = make_reads(kmap, n=B, read_len=80)
keys = list(kmap)
# one hit-dense read in EACH process's half -> exercises the replicated
# overflow-count replay branch across processes
for row in (B // 2 - 1, B - 1):
    seq = "".join(codec.key_to_string(keys[(row * 5 + j) %% len(keys)])
                  for j in range(12))
    records[row] = (f"dense{row}", seq, None)
codes = np.full((B, L), 4, np.uint8)
lengths = np.zeros(B, np.int32)
for i, (acc, seq, qual) in enumerate(records):
    c = codec.encode_bases(seq)[:L]
    codes[i, : len(c)] = c
    lengths[i] = len(c)

single = FpClassifier(packed, tax, batch_size=B, max_len=L, max_hits=MH, fpdb=fp)
s1 = single.new_seen()
s1, finals1 = single.process_batch(s1, Batch(codes, lengths, [None] * B, B))
u1 = single.ucount(s1)

mesh = make_mesh(data=2, db=2)
shard = ShardedFpClassifier(packed, tax, mesh, batch_size=B, max_len=L,
                            max_hits=MH, fpdb=fp)
seen = shard.new_seen()
lo, hi = pid * B // 2, (pid + 1) * B // 2
gcodes, glens = shard.make_global_batch(codes[lo:hi], lengths[lo:hi])
seen, pending = shard.submit_batch(seen, Batch(gcodes, glens, [None] * B, B))
seen, rows, finals2 = shard.collect_local(seen, pending)
assert (rows == np.arange(lo, hi)).all(), rows
assert (finals2 == np.asarray(finals1)[rows]).all(), (
    finals2.tolist(), np.asarray(finals1)[rows].tolist())

# device-side finalize: the in-mesh psum/segment-sum path — no host
# allgather of the seen bitmap (GBs at production slot counts)
u2 = shard.ucount(seen)
assert u1.tolist() == u2.tolist(), (u1.tolist(), u2.tolist())
print(json.dumps({"pid": pid, "rows": int(len(rows)), "ucount_sum": int(u2.sum())}))
"""


def test_two_process_sharded_fp_classifier(tmp_path):
    """The PRODUCTION sharded fp engine under real jax.distributed: 2
    processes x 2 CPU devices form a (data=2, db=2) mesh; per-process local
    batch rows enter via make_array_from_process_local_data; per-row finals
    and global ucount must equal the single-device engine, including the
    cross-process candidate-overflow replay."""
    coord = f"127.0.0.1:{_free_port()}"
    script = _CLF_WORKER % {"root": ROOT, "coord": coord}
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=400)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0]["rows"] == outs[1]["rows"] == 32
    assert outs[0]["ucount_sum"] == outs[1]["ucount_sum"] > 0
