"""Multi-process sample driver: `classify-nx --num-processes 2` end-to-end.

The sharded engine's multi-process API, driven by the real CLI: this test
launches TWO real jax.distributed processes (CPU,
2 virtual devices each -> one 4-device global mesh) running the actual CLI
`classify-nx` command over a shared fastq directory, and asserts the
process-0 outputs (`_result.txt`, `_reads.txt`) are byte-identical to a
single-process run of the same CLI on the same inputs."""

import gzip
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

rng = np.random.default_rng(31)
BASES = np.array(list("ACGT"))


def rand_dna(n):
    return "".join(BASES[rng.integers(0, 4, size=n)])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny nx-layout world: probe DB (targets 2..7) + one paired sample."""
    sys.path.insert(0, ROOT)
    from kmer_id_tpu.core import codec
    from kmer_id_tpu.db.probes import ProbeRecords, write_probes_text

    base = tmp_path_factory.mktemp("mpdrv")
    dbdir = base / "db"
    dbdir.mkdir()
    kmers = {}
    while len(kmers) < 120:
        s = rand_dna(30)
        key, _, _ = codec.canonical_kmers(codec.encode_bases(s))
        if len(key) and int(key[0]) not in kmers:
            kmers[int(key[0])] = 2 + len(kmers) % 6
    keys = np.array(sorted(kmers), dtype=np.uint64)
    rec = ProbeRecords(
        keys=keys,
        target=np.array([kmers[int(k)] for k in keys], dtype=np.int32),
        org=np.zeros(len(keys), np.int32),
        position=np.zeros(len(keys), np.int32),
        fstrand=np.ones(len(keys), bool),
        count=np.ones(len(keys), np.int32),
    )
    write_probes_text(rec, str(dbdir / "probes.txt"))
    with open(dbdir / "probes.txt", "rb") as fi, gzip.open(
        dbdir / "probes.txt.gz", "wb"
    ) as fo:
        fo.write(fi.read())
    (dbdir / "data.txt").write_text(
        "".join(f"{2 + i % 6}\tacc{i}\n" for i in range(6))
    )
    (dbdir / "tree.txt").write_text("1\t2\n1\t3\n2\t4\n2\t5\n1\t6\n6\t7\n")

    def reads_fastq(path, n, tag):
        with gzip.open(path, "wt") as f:
            for i in range(n):
                if rng.random() < 0.8:
                    k = int(keys[rng.integers(len(keys))])
                    ins = codec.key_to_string(k)
                    if rng.random() < 0.5:
                        ins = codec.key_to_string(codec.revcomp_key(k))
                    pad = 70
                    left = int(rng.integers(0, pad + 1))
                    seq = rand_dna(left) + ins + rand_dna(pad - left)
                else:
                    seq = rand_dna(100)
                qual = "".join(
                    chr(int(c)) for c in rng.integers(35, 74, size=len(seq))
                )
                f.write(f"@{tag}{i}\n{seq}\n+\n{qual}\n")

    for sdir in ("single", "multi"):
        d = base / sdir
        d.mkdir()
    rng_state = rng.bit_generator.state
    reads_fastq(base / "single" / "s1_R1_tr.fastq.gz", 300, "a")
    reads_fastq(base / "single" / "s1_R2_tr.fastq.gz", 150, "b")
    rng.bit_generator.state = rng_state  # identical reads in both dirs
    reads_fastq(base / "multi" / "s1_R1_tr.fastq.gz", 300, "a")
    reads_fastq(base / "multi" / "s1_R2_tr.fastq.gz", 150, "b")
    return base, dbdir


def _cli_args(fastq_dir, dbdir, mesh_data):
    return [
        sys.executable, "-m", "kmer_id_tpu.cli", "classify-nx", str(fastq_dir),
        "--data", str(dbdir / "data.txt"), "--tree", str(dbdir / "tree.txt"),
        "--probes", str(dbdir / "probes.txt.gz"), "--num-targ", "8",
        "--batch-size", "64", "--max-len", "128",
        "--mesh-data", str(mesh_data),
    ]


def _env(ndev):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_classify_nx_two_processes_byte_identical(world):
    base, dbdir = world
    # single-process truth (sharded engine on a local 2-device mesh)
    r = subprocess.run(
        _cli_args(base / "single", dbdir, 2), env=_env(2),
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]

    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        args = _cli_args(base / "multi", dbdir, 4) + [
            "--coordinator", coord, "--num-processes", "2",
            "--process-id", str(pid),
        ]
        procs.append(subprocess.Popen(
            args, env=_env(2), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT,
        ))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so[-2000:] + se[-2000:]

    for fname in ("s1_result.txt", "s1_reads.txt"):
        want = (base / "single" / fname).read_bytes()
        got = (base / "multi" / fname).read_bytes()
        assert got == want, f"{fname} differs between 1- and 2-process runs"
    assert len((base / "multi" / "s1_result.txt").read_bytes()) > 0
