"""Command-line interface: every reference entry point as a subcommand.

Reference → subcommand map (SURVEY.md §2.1):

* ``kmer_build_vf6 -name -fadir``       → ``build-db``
* ``nk10 <fastq_dir>``                  → ``classify-nx``
* ``kmerreadc -name -fadir -jname -target`` → ``classify-jobs``
* ``kmerread -wdir -f1 -f2``            → ``classify-m3``
* ``readbatch_10.py`` / ``readbatch_c3.py`` → ``report-b10`` / ``report-c3``
* ``kmer_read_m3.py -w -d -i f1 f2``    → ``mitokmer`` (classify + report)
* ``kmer_readc.py``                     → ``readc`` (jobs classify + report)
* (new) ``pack-db``                     → one-time packed-artifact build

Plus mesh flags (``--mesh-data/--mesh-db``) to run any classify command
data-parallel and/or DB-sharded.
"""

from __future__ import annotations

import argparse
import sys

from kmer_id_tpu.config import BuildConfig, ClassifyConfig
from kmer_id_tpu.utils.logging import log, set_verbosity


def _add_mesh_args(p):
    p.add_argument("--mesh-data", type=int, default=1, help="data-parallel axis size")
    p.add_argument("--mesh-db", type=int, default=1, help="DB key-range shard axis size")
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--cache-dir", default=None, help="packed-DB artifact cache dir")
    p.add_argument("--engine", choices=("fp", "legacy"), default="fp",
                   help="fp = fingerprint engine (production); legacy = sorted-array")
    # multi-host (jax.distributed) wiring: run one process per host with the
    # same command; the mesh then spans every host's devices
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-host runs)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the run to DIR")


# subcommands that classify on the device (the others run on the host only)
_DEVICE_CMDS = ("classify-nx", "classify-jobs", "classify-m3", "mitokmer", "readc")


def _make_classifier(db, cfg, args):
    if args.mesh_data * args.mesh_db > 1:
        from kmer_id_tpu.parallel import (
            ShardedClassifier,
            ShardedFpClassifier,
            make_mesh,
        )

        mesh = make_mesh(data=args.mesh_data, db=args.mesh_db)
        if getattr(args, "engine", "fp") != "fp":
            return ShardedClassifier(
                db.packed, db.taxonomy, mesh, cfg.batch_size, cfg.max_len
            )
        from kmer_id_tpu.engine.pipeline import load_or_build_fpdb

        return ShardedFpClassifier(
            db.packed, db.taxonomy, mesh, cfg.batch_size, cfg.max_len,
            fpdb=load_or_build_fpdb(db, getattr(args, "cache_dir", None)),
        )
    from kmer_id_tpu.engine.pipeline import make_classifier

    return make_classifier(db, cfg, cache_dir=getattr(args, "cache_dir", None))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kmer_id_tpu")
    ap.add_argument("-v", "--verbose", action="count", default=1)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-db", help="3-pass probe DB construction")
    b.add_argument("-name", required=True)
    b.add_argument("-fadir", default="")
    b.add_argument("-outdir", default="")
    b.add_argument("--root", default=".")
    b.add_argument("--spill", action="store_true",
                   help="disk-spilled bounded-memory build (corpus-scale DBs)")
    b.add_argument("--spill-shard-bits", type=int, default=6)
    b.add_argument("--spill-batch-mb", type=int, default=1024)

    nx = sub.add_parser("classify-nx", help="batch-classify paired samples in a dir")
    nx.add_argument("fastq_dir")
    nx.add_argument("--db-dir", default="./bact10")
    nx.add_argument("--data", default=None, help="override *data.txt path")
    nx.add_argument("--tree", default=None)
    nx.add_argument("--probes", default=None)
    nx.add_argument("--e1", default="_R1_tr.fastq.gz")
    nx.add_argument("--e2", default="_R2_tr.fastq.gz")
    nx.add_argument("--num-targ", type=int, default=5982)
    nx.add_argument("--fasta", action="store_true", help="FASTA mode (FASTQ=0)")
    nx.add_argument("--resume", action="store_true")
    nx.add_argument("--metrics", default=None, metavar="JSONL",
                    help="write per-sample metrics to this JSONL file")
    _add_mesh_args(nx)

    vj = sub.add_parser("classify-jobs", help="vf6 job-based classification")
    vj.add_argument("-name", required=True)
    vj.add_argument("-jname", required=True)
    vj.add_argument("-fadir", default="")
    vj.add_argument("-target", type=int, default=0)
    vj.add_argument("--root", default=".")
    _add_mesh_args(vj)

    m3 = sub.add_parser("classify-m3", help="single-sample mitochondrial run")
    m3.add_argument("-wdir", required=True)
    m3.add_argument("-f1", required=True)
    m3.add_argument("-f2", default="none")
    _add_mesh_args(m3)

    rb = sub.add_parser("report-b10", help="readbatch_10-compatible rollup")
    rb.add_argument("result_dir")
    rb.add_argument("refkey")
    rb.add_argument("out_csv")
    rb.add_argument("--no-default-excludes", action="store_true")

    rc3 = sub.add_parser("report-c3", help="readbatch_c3-compatible rollup")
    rc3.add_argument("result_dir")
    rc3.add_argument("refkey")
    rc3.add_argument("out_csv")

    mk = sub.add_parser("mitokmer", help="Galaxy orchestrator (kmer_read_m3.py)")
    mk.add_argument("-w", dest="wdir", required=True)
    mk.add_argument("-d", dest="outdir", required=True)
    mk.add_argument("-i", dest="inputs", nargs=2, required=True)
    mk.add_argument("--strip-cr", action="store_true",
                    help="normalize CRLF refkeys (reference crashes on them)")
    _add_mesh_args(mk)

    rd = sub.add_parser("readc", help="chloroplast orchestrator (kmer_readc.py)")
    rd.add_argument("--jobs-name", required=True)
    rd.add_argument("--folder", required=True)
    rd.add_argument("--fadir", default="")
    rd.add_argument("--target", type=int, default=0)
    rd.add_argument("--root", default=".")
    _add_mesh_args(rd)

    pk = sub.add_parser("pack-db", help="probes text -> packed mmap artifact")
    pk.add_argument("probes")
    pk.add_argument("out_dir")
    pk.add_argument("--num-targ", type=int, required=True)

    args = ap.parse_args(argv)
    set_verbosity(args.verbose)

    from kmer_id_tpu.utils.device import device_summary, setup_compile_cache

    setup_compile_cache()

    # Multi-host bring-up must happen before ANYTHING instantiates a JAX
    # backend (an earlier backend touch would silently latch a single-process
    # device view); DB loading below imports jax transitively.
    if getattr(args, "num_processes", None):
        import jax

        from kmer_id_tpu.parallel.distributed import initialize

        initialize(args.coordinator, args.num_processes, args.process_id)
        if jax.process_count() != args.num_processes:
            raise SystemExit(
                f"jax.distributed came up with {jax.process_count()} processes, "
                f"expected {args.num_processes} (was a backend touched before "
                "initialize()?)"
            )
        from kmer_id_tpu.parallel.distributed import health_check

        h = health_check()
        log(f"health: {h}")
        if not h["ok"]:
            raise SystemExit(f"device health check failed: {h}")

    if args.cmd in _DEVICE_CMDS:
        d = device_summary()
        log(f"devices: platform={d['platform']} kind={d['kind']} count={d['count']}")

    if args.cmd == "build-db":
        if args.spill:
            from kmer_id_tpu.db.spill import build_probes_spill

            res = build_probes_spill(
                args.name, args.fadir, args.outdir, root=args.root,
                shard_bits=args.spill_shard_bits,
                batch_bytes=args.spill_batch_mb << 20,
            )
        else:
            from kmer_id_tpu.db.build import build_probes

            res = build_probes(args.name, args.fadir, args.outdir, root=args.root)
        log(f"built {len(res.records)} probes over {res.num_targ} targets")
        return 0

    if args.cmd == "pack-db":
        from kmer_id_tpu.db.probes import parse_probes_text, pack_probes, save_packed

        rec = parse_probes_text(args.probes)
        packed = pack_probes(rec, num_targ=args.num_targ)
        save_packed(packed, args.out_dir)
        log(f"packed {len(packed)} unique keys -> {args.out_dir}")
        return 0

    from kmer_id_tpu.utils.timing import profile_trace

    if args.cmd == "classify-nx":
        import os

        from kmer_id_tpu.engine.pipeline import load_db, run_nx

        dbd = args.db_dir
        db = load_db(
            args.data or os.path.join(dbd, "bData10.txt"),
            args.tree or os.path.join(dbd, "btree_10.txt"),
            args.probes or os.path.join(dbd, "probes10.txt.gz"),
            num_targ=args.num_targ,
            cache_dir=args.cache_dir,
        )
        cfg = ClassifyConfig.preset(
            "nx", num_targ=args.num_targ, batch_size=args.batch_size,
            max_len=args.max_len,
        )
        clf = _make_classifier(db, cfg, args)
        with profile_trace(args.profile):
            run_nx(args.fastq_dir, db, cfg, e1=args.e1, e2=args.e2,
                   fasta_mode=args.fasta, resume=args.resume, clf=clf,
                   metrics_path=args.metrics)
        return 0

    if args.cmd == "classify-jobs":
        import os

        from kmer_id_tpu.engine.pipeline import load_db, run_vf6

        wdir = os.path.join(args.root, args.name)
        db = load_db(
            os.path.join(wdir, f"{args.name}_data.txt"),
            os.path.join(wdir, f"{args.name}_tree.txt"),
            os.path.join(wdir, f"{args.name}_probes.txt.gz"),
            cache_dir=args.cache_dir,
        )
        cfg = ClassifyConfig.preset(
            "vf6", save_target=args.target, batch_size=args.batch_size,
            max_len=args.max_len,
        )
        clf = _make_classifier(db, cfg, args)
        with profile_trace(args.profile):
            run_vf6(args.name, args.jname, db, cfg, root=args.root, clf=clf)
        return 0

    if args.cmd == "classify-m3":
        from kmer_id_tpu.engine.pipeline import run_m3

        cfg = ClassifyConfig.preset(
            "m3", batch_size=args.batch_size, max_len=args.max_len
        )
        with profile_trace(args.profile):
            run_m3(args.wdir, args.f1, args.f2, cfg=cfg)
        return 0

    if args.cmd == "report-b10":
        from kmer_id_tpu.report.rollup import readbatch_10

        readbatch_10(
            args.result_dir, args.refkey, args.out_csv,
            exclude=set() if args.no_default_excludes else None,
        )
        return 0

    if args.cmd == "report-c3":
        from kmer_id_tpu.report.rollup import readbatch_c3

        readbatch_c3(args.result_dir, args.refkey, args.out_csv)
        return 0

    if args.cmd == "mitokmer":
        import os

        from kmer_id_tpu.engine.pipeline import run_m3
        from kmer_id_tpu.report.rollup import m3_report

        wdir = args.wdir + "/"
        cfg = ClassifyConfig.preset(
            "m3", batch_size=args.batch_size, max_len=args.max_len
        )
        run_m3(wdir, args.inputs[0], args.inputs[1], cfg=cfg)
        os.makedirs(args.outdir, exist_ok=True)
        m3_report(
            os.path.join(wdir, "result.txt"),
            os.path.join(wdir, "mitochondria_refkey.txt"),
            os.path.join(args.outdir, "mitokmer_result.csv"),
            strip_cr=args.strip_cr,
        )
        return 0

    if args.cmd == "readc":
        import os

        from kmer_id_tpu.engine.pipeline import load_db, run_vf6
        from kmer_id_tpu.report.rollup import readc_report

        wdir = os.path.join(args.root, args.folder)
        db = load_db(
            os.path.join(wdir, f"{args.folder}_data.txt"),
            os.path.join(wdir, f"{args.folder}_tree.txt"),
            os.path.join(wdir, f"{args.folder}_probes.txt.gz"),
            cache_dir=args.cache_dir,
        )
        cfg = ClassifyConfig.preset(
            "vf6", save_target=args.target, batch_size=args.batch_size,
            max_len=args.max_len,
        )
        clf = _make_classifier(db, cfg, args)
        run_vf6(args.folder, args.jobs_name, db, cfg, root=args.root, clf=clf)
        jdir = os.path.join(args.root, args.jobs_name)
        readc_report(
            jdir, args.jobs_name,
            os.path.join(wdir, f"{args.folder}_key.txt"),
            os.path.join(wdir, f"{args.folder}_count.txt"),
            os.path.join(jdir, f"{args.jobs_name}.csv"),
        )
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
