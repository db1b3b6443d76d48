"""Process set-up: compile cache, device log, one card per process, and the
chip smoke test's phases at a tiny size on the CPU."""

import json
import os

import jax
import numpy as np
import pytest

import chip_smoke
from kmer_id_tpu.utils import device


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device.setup_compile_cache() == str(tmp_path)
        # JAX's own setting is left alone; no second directory is set
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = device.setup_compile_cache()
        assert got == os.path.join(device.REPO_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # a fixed path: the same on every call and in every process
        assert device.setup_compile_cache() == got


def test_device_summary_names_the_backend():
    d = device.device_summary()
    assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}


@pytest.mark.parametrize("coordinator,num,pid,env,want", [
    # one host: process i opens card i
    ("localhost:1234", 4, 2, {}, [2]),
    ("127.0.0.1:1234", 4, 3, {}, [3]),
    # the launcher pins the card itself
    ("localhost:1234", 4, 2, {"CUDA_VISIBLE_DEVICES": "3"}, None),
    # across hosts the global id is no card index: the local rank is
    ("10.0.0.1:1234", 8, 5, {"LOCAL_RANK": "1"}, [1]),
    ("10.0.0.1:1234", 8, 5, {}, None),
    # process id left to JAX's cluster detection
    ("localhost:1234", 4, None, {}, None),
    ("localhost:1234", 4, None, {"LOCAL_RANK": "2"}, [2]),
])
def test_distributed_initialize_opens_own_card(coordinator, num, pid, env,
                                               want, monkeypatch):
    from kmer_id_tpu.parallel import distributed

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "log", lambda *_a, **_k: None)
    for var in ("CUDA_VISIBLE_DEVICES", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    distributed.initialize(coordinator, num, pid)
    distributed.initialize(coordinator, 1, 0)  # single process: no-op
    assert len(calls) == 1
    kw = calls[0]
    assert (kw["coordinator_address"], kw["num_processes"],
            kw["process_id"]) == (coordinator, num, pid)
    assert kw["local_device_ids"] == want


def test_chip_smoke_phases_tiny(tmp_path):
    """The smoke's phases end to end on the CPU at a tiny size: DB build,
    samples, reference simulator, CLI classification, byte comparison."""
    work = str(tmp_path)
    db = chip_smoke.make_db(work, n_probes=20_000, num_targ=64, n_orgs=100,
                            seed=5)
    samples = chip_smoke.make_samples(work, db, n_reads=600, n_contigs=3,
                                      contig_len=(400, 1200), seed=5)
    reference = chip_smoke.start_reference(db, samples)  # child process
    chip_smoke.run_cli(work, db, batch=256, max_len=160)
    expected = reference()
    assert set(expected) == {"fq", "fa"}
    assert expected == chip_smoke.reference_outputs(db, samples)
    chip_smoke.compare(work, expected, "cpu")
    # the sample really exercises classification and saved-read capture
    res, reads = expected["fq"]
    classified = sum(int(line.split(",")[1]) for line in res.splitlines()[1:])
    assert classified > 300 and reads.count(">") > 50
    bad = dict(expected)
    bad["fq"] = (res, reads + ">2:x\nACGT\n")
    with pytest.raises(SystemExit):
        chip_smoke.compare(work, bad, "cpu")


@pytest.mark.parametrize("fault", ["drop", "retarget"])
def test_chip_smoke_catches_a_packing_fault(fault, tmp_path, monkeypatch):
    """The reference reads the probes as generated, not the packed artifact,
    so a packing fault that loses or re-targets probes fails the comparison."""
    from kmer_id_tpu.db import probes as P

    real = P.pack_probes

    def faulty(rec, num_targ):
        keep = np.arange(len(rec.keys)) % 2 == 0 if fault == "drop" else slice(None)
        target = rec.target if fault == "drop" else rec.target % (num_targ - 2) + 2
        return real(P.ProbeRecords(
            keys=rec.keys[keep], target=target[keep], org=rec.org[keep],
            position=rec.position[keep], fstrand=rec.fstrand[keep],
            count=rec.count[keep]), num_targ=num_targ)

    monkeypatch.setattr(P, "pack_probes", faulty)
    work = str(tmp_path)
    db = chip_smoke.make_db(work, n_probes=20_000, num_targ=64, n_orgs=100,
                            seed=6)
    samples = chip_smoke.make_samples(work, db, n_reads=300, n_contigs=2,
                                      contig_len=(400, 800), seed=6)
    chip_smoke.run_cli(work, db, batch=256, max_len=160)
    with pytest.raises(SystemExit, match="differs from the reference"):
        chip_smoke.compare(work, chip_smoke.reference_outputs(db, samples),
                           "cpu")


def test_chip_smoke_refuses_cpu(capsys, restore_cache_dir):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "GPU" in str(e.value)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_sample_keys_cover_every_window():
    recs = [("a", "ACGTACGTACGTACGTACGTACGTACGTACGTA", None),
            ("b", "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT", "J" * 32)]
    from kmer_id_tpu.core import codec

    want = set()
    for _, seq, _ in recs:
        keys, _, _ = codec.canonical_kmers(codec.encode_bases(seq))
        want.update(int(k) for k in keys)
    got = chip_smoke._sample_keys(recs)
    assert want <= set(int(k) for k in got)
    assert np.all(got[1:] > got[:-1])
