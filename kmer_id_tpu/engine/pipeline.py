"""Sample/job drivers: the reference `main()` loops on the device engines.

Covers the three classifier drivers (SURVEY.md §2.2 nx/vf6/m3 rows) on top of
one engine: DB loading (text probes → packed artifact with caching), the
per-sample counter-reset loop, ordered saved-read capture, result.txt output,
and a completed-sample manifest enabling restart at sample granularity (the
failure-recovery subsystem the reference lacks — a crash mid-batch loses
everything there, SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional, TextIO

import numpy as np

from kmer_id_tpu.config import ClassifyConfig
from kmer_id_tpu.core.taxonomy import Taxonomy
from kmer_id_tpu.db.metadata import StrainList, load_data_txt, load_tree_edges
from kmer_id_tpu.db.probes import (
    PackedDB,
    load_packed,
    pack_probes,
    parse_probes_text,
    save_packed,
)
from kmer_id_tpu.engine.classify import Classifier
from kmer_id_tpu.io.batch import Batch, LongRead, ReadBatcher
from kmer_id_tpu.io.fastx import iter_fastq_gz, iter_fasta_plain, iter_reads_auto
from kmer_id_tpu.utils.logging import log


@dataclass
class LoadedDB:
    packed: PackedDB
    taxonomy: Taxonomy
    strains: StrainList
    num_targ: int
    kmers_loaded: int  # probe rows parsed (m3's "<2 kmers" gate uses this)


def load_db(
    data_path: str,
    tree_path: str,
    probes_path: str,
    num_targ: int | None = None,
    cache_dir: str | None = None,
    require_tree: bool = False,
) -> LoadedDB:
    """Load data/tree/probes into a packed DB + taxonomy.

    ``cache_dir``: if set, the packed artifact is saved there on first load
    and memory-mapped afterwards (replacing the reference's minutes-long text
    re-parse at every startup, ``newkmer_10nx.cpp:988``).
    """
    strains = load_data_txt(data_path)
    nt = num_targ if num_targ is not None else strains.num_targ
    if not os.path.exists(tree_path):
        if require_tree:
            raise SystemExit(1)  # kmer_read_m3.cpp:1060
        edges = []
    else:
        edges = load_tree_edges(tree_path)
    taxonomy = Taxonomy.from_edges(edges, num_nodes=nt)

    packed = None
    n_rows = -1
    if cache_dir and os.path.exists(os.path.join(cache_dir, "manifest.json")):
        try:
            packed = load_packed(cache_dir)
            with open(os.path.join(cache_dir, "manifest.json")) as f:
                n_rows = json.load(f).get("source_rows", -1)
        except Exception:
            packed = None
    if packed is None:
        records = parse_probes_text(probes_path)
        n_rows = len(records)
        packed = pack_probes(records, num_targ=nt)
        if cache_dir:
            save_packed(packed, cache_dir)
            mpath = os.path.join(cache_dir, "manifest.json")
            with open(mpath) as f:
                manifest = json.load(f)
            manifest["source_rows"] = n_rows
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
    return LoadedDB(packed, taxonomy, strains, nt, n_rows)


def make_classifier(db: LoadedDB, cfg: ClassifyConfig, cache_dir: str | None = None):
    """Engine selection: the fingerprint engine (engine/fpclassify.py) is the
    production single-chip path; the legacy sorted/cuckoo engine remains for
    the alignment-verification replay (needs per-window strand/index detail)
    and as the behavioral cross-check in tests."""
    if cfg.minalign > 0 or getattr(cfg, "engine", "fp") != "fp":
        return Classifier(db.packed, db.taxonomy, cfg.batch_size, cfg.max_len)
    from kmer_id_tpu.engine.fpclassify import FpClassifier

    fp = load_or_build_fpdb(db, cache_dir)
    try:
        return FpClassifier(
            db.packed, db.taxonomy, cfg.batch_size, cfg.max_len, fpdb=fp
        )
    except ValueError:
        return Classifier(db.packed, db.taxonomy, cfg.batch_size, cfg.max_len)


def load_or_build_fpdb(db: LoadedDB, cache_dir: str | None = None):
    """The fingerprint tables of ``db``: loaded from ``cache_dir`` when it
    holds them for this DB, else built (and saved there when given)."""
    from kmer_id_tpu.db.fpdb import build_fpdb, load_fpdb, save_fpdb

    fp = None
    if cache_dir:
        fp = load_fpdb(cache_dir)
        if fp is not None and fp.slot_idx.max(initial=-1) >= len(db.packed):
            fp = None  # stale cache from a different DB
    if fp is None:
        fp = build_fpdb(db.packed, db.taxonomy)
        if cache_dir:
            save_fpdb(fp, cache_dir)
    return fp


# ----------------------------------------------------------------- samples


@dataclass
class SampleResult:
    gcount: np.ndarray  # int64 [num_targ]
    ucount: np.ndarray  # int64 [num_targ]
    reads: int  # processed read count (tct analog)
    wall_s: float = 0.0
    stage_s: dict = field(default_factory=dict)


class SampleProcessor:
    """One sample = one counter-reset unit (``newkmer_10nx.cpp:1015-1045``).

    Two feed paths produce identical results (asserted in tests):

    * :meth:`feed` — pure-Python records through io/batch.ReadBatcher (the
      behavioral reference, also the fallback without a C++ toolchain);
    * :meth:`feed_file` — the native decoder fills [B, L] planes directly
      (io/native_feed.py); per-read Python work shrinks to the final-call
      accounting loop.
    """

    def __init__(
        self,
        clf: Classifier,
        cfg: ClassifyConfig,
        reads_out: Optional[TextIO] = None,
        target_reads_out: Optional[TextIO] = None,
        use_native: bool | None = None,
    ):
        from kmer_id_tpu.io.native_feed import NativePlaneFeeder, native_available

        self.clf = clf
        self.cfg = cfg
        self.reads_out = reads_out
        self.target_reads_out = target_reads_out
        self.gcount = np.zeros(clf.num_targ, dtype=np.int64)
        self.reads = 0
        self.seen = clf.new_seen()
        # Separate unique-k-mer accumulator for the collector thread: the
        # main thread donates ``seen`` through the submit chain while the
        # worker scatters overflow/long-read hits into ``seen_ovr`` — the
        # two buffer-donation chains never cross threads.  ``seen`` is a set
        # union, so a max-merge at finalize is exact.
        self.seen_ovr = clf.new_seen()
        self.batcher = ReadBatcher(clf.batch_size, clf.max_len, u_is_t=cfg.u_is_t)
        # verify mode replays reads sequentially host-side and needs the
        # full-read trim metadata only the Python batcher carries
        if cfg.minalign > 0:
            use_native = False
        self.native = native_available() if use_native is None else use_native
        self._feeder = (
            NativePlaneFeeder(clf.batch_size, clf.max_len, cfg.u_is_t)
            if self.native
            else None
        )
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        from kmer_id_tpu.utils.timing import StageTimers

        # Multi-process data-parallel feed (sharded engines under
        # jax.distributed): every process decodes the whole stream — cheap
        # next to classification — slices each batch to the rows its data
        # shards own, and collects the FULL finals via collect_global, so
        # gcount and the ordered saved-read capture stay identical on every
        # process; process 0 writes the outputs (drivers pass reads_out
        # only there).
        import jax as _jax

        self._mp_rows = None
        if _jax.process_count() > 1 and hasattr(clf, "local_data_rows"):
            self._mp_rows = clf.local_data_rows()

        self._inflight = deque()  # futures of the collector thread, FIFO
        self.pipeline_depth = 4  # collector jobs in flight hides latency
        # Submitter thread: device_put + dispatch block the calling thread
        # for about the host->device copy time, which would serialize decode
        # against transfer on the main thread.  A single submitter worker
        # preserves submit order (and with it the exact account order and
        # the seen-donation chain, which now lives entirely on this thread)
        # while the main thread runs ahead decoding.  Disabled in
        # multi-process mode (strict global collective order) and verify
        # mode (sequential by design).
        self._sub_q: deque = deque()
        self._submitter = (
            ThreadPoolExecutor(max_workers=1)
            if self._mp_rows is None and cfg.minalign == 0
            else None
        )
        if self._mp_rows is not None:
            # Multi-process runs must issue every collective in the SAME
            # global order on every process (jax.distributed rendezvous);
            # async collector jobs would interleave submit/collect
            # nondeterministically per process and deadlock the mesh, so
            # the pipeline degrades to strict submit -> collect per batch.
            self.pipeline_depth = 0
        # Grouped collection: the finals of collect_group batches are
        # fetched in ONE device->host roundtrip (engines exposing
        # collect_many).  Long reads flush the group first so account order
        # stays exactly read order.  Whether the submitter thread, grouping
        # and the collector thread pay for themselves on the H100's local
        # PCIe link is not measured (ROADMAP C4).
        self.collect_group = 4 if hasattr(clf, "collect_many") else 1
        self._group: list = []  # [(pending, Batch)] awaiting a group job
        # One collector thread overlaps the per-batch device fetch with the
        # main thread's decode+pack+submit.  Exactly one worker keeps the
        # read-order accounting sequential.
        self._collector = ThreadPoolExecutor(max_workers=1)
        self.timers = StageTimers()
        self._t_start = __import__("time").monotonic()
        self._verify = None
        if cfg.minalign > 0:
            from kmer_id_tpu.engine.verify import AlignVerifier, GenomeCache

            genomes = GenomeCache(
                cfg.fadir, cfg.accessions or [], u_is_t=cfg.u_is_t
            )
            self._verify = {
                "verifier": AlignVerifier(genomes, clf.packed_db, cfg.minalign),
                "ucount": np.zeros(clf.num_targ, dtype=np.int64),
                "kmer_seen": set(),
            }

    def _enqueue(self, fn, *a) -> None:
        """Run a consume step on the submitter thread (order-preserving
        FIFO with bounded lookahead), or inline when disabled."""
        if self._submitter is None:
            fn(*a)
            return
        self._sub_q.append(self._submitter.submit(fn, *a))
        while len(self._sub_q) > 6:
            self._sub_q.popleft().result()

    def _drain_submits(self) -> None:
        while self._sub_q:
            self._sub_q.popleft().result()

    def feed(self, records: Iterable) -> None:
        # Both feed paths enqueue to the same single-worker collector FIFO,
        # so account order stays exact without draining the pipeline here
        # (callers streaming many small feed() chunks keep full overlap).
        for acc, seq, qual in records:
            for item in self.batcher.add(acc, seq, qual):
                self._enqueue(self._consume, item)

    def feed_file(self, path, fmt: str | None = None) -> None:
        """Stream one read file (extension-dispatched, vf6:1133-1152;
        pass ``fmt`` to force a parser like the nx driver's FASTQ mode)."""
        if self._feeder is not None:
            with self.timers.stage("decode+classify"):
                for nb in self._feeder.feed_path(str(path), fmt=fmt):
                    self._enqueue(self._consume_native, nb)
            return
        from kmer_id_tpu.io import fastx
        from kmer_id_tpu.io.native import detect_format

        fmt = fmt or detect_format(str(path))
        iters = {
            "fastq_gz": fastx.iter_fastq_gz,
            "fastq": fastx.iter_fastq_plain,
            "fasta_gz": fastx.iter_fasta_gz,
            "fasta": fastx.iter_fasta_plain,
        }
        if fmt in iters:
            self.feed(iters[fmt](str(path)))

    def finish(self) -> SampleResult:
        if self._feeder is not None:
            for nb in self._feeder.flush():
                self._enqueue(self._consume_native, nb)
        for item in self.batcher.flush():
            self._enqueue(self._consume, item)
        self._drain_submits()
        if self._submitter is not None:
            self._submitter.shutdown(wait=True)
        self._barrier()
        self._collector.shutdown(wait=True)
        if self._verify is not None:
            ucount = self._verify["ucount"]
        else:
            with self.timers.stage("finalize"):
                import jax.numpy as jnp

                ucount = self.clf.ucount(jnp.maximum(self.seen, self.seen_ovr))
        import time as _time

        wall = _time.monotonic() - self._t_start
        classified = int(self.reads - (self.gcount[0] if len(self.gcount) else 0))
        log(
            f"sample done: {self.reads} reads in {wall:.2f}s "
            f"({self.reads / max(wall, 1e-9):,.0f} r/s, "
            f"{100.0 * classified / max(self.reads, 1):.1f}% classified) "
            f"stages={self.timers.summary()}",
            level=2,
        )
        return SampleResult(
            gcount=self.gcount, ucount=ucount, reads=self.reads,
            wall_s=wall, stage_s=self.timers.summary(),
        )

    # ------------------------------------------------------------ internals
    def _consume(self, item) -> None:
        """Python-batcher path: submit on the main thread, collect + account
        on the single collector worker (same overlap as the native path;
        FIFO keeps account order exact across both paths)."""
        if self._verify is not None and isinstance(item, Batch):
            self._replay_verify(item)
            return
        if isinstance(item, LongRead):
            self._flush_group()  # account order = read order
            self._inflight.append(self._collector.submit(self._long_job, item))
        else:
            self.seen, pending = self._submit(item)
            self._group.append((pending, item))
            if len(self._group) >= self.collect_group:
                self._flush_group()
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().result()

    def _submit(self, batch: Batch):
        """Engine submit; multi-process mode feeds the process-local row
        slice through make_global_batch (see __init__)."""
        if self._mp_rows is None:
            return self.clf.submit_batch(self.seen, batch)
        import dataclasses

        cg, lg = self.clf.make_global_batch(
            np.ascontiguousarray(batch.codes[self._mp_rows]),
            np.ascontiguousarray(batch.lengths[self._mp_rows]),
        )
        gb = dataclasses.replace(batch, codes=cg, lengths=lg,
                                 packed=None, exc=None)
        return self.clf.submit_batch(self.seen, gb)

    def _flush_group(self) -> None:
        if self._group:
            grp, self._group = self._group, []
            self._inflight.append(self._collector.submit(self._group_job, grp))

    def _group_job(self, grp) -> None:
        if len(grp) == 1 or not hasattr(self.clf, "collect_many"):
            collect = (
                self.clf.collect_global
                if self._mp_rows is not None
                else self.clf.collect
            )
            for pending, batch in grp:
                self.seen_ovr, finals = collect(self.seen_ovr, pending)
                self._account_batch(finals[: batch.n_rows], batch.metas)
            return
        self.seen_ovr, finals_list = self.clf.collect_many(
            self.seen_ovr, [p for p, _ in grp]
        )
        for (pending, batch), finals in zip(grp, finals_list):
            self._account_batch(finals, batch.metas)

    def _long_job(self, item: LongRead) -> None:
        if self._mp_rows is not None:
            raise NotImplementedError(
                "long reads (> max_len) are not yet supported in the "
                "multi-process data-parallel driver; raise max_len or run "
                "the sample queue split (one process per sample) instead"
            )
        self.seen_ovr, final = self.clf.process_long(self.seen_ovr, item)
        self._account(int(final), item.meta)

    def _consume_native(self, nb) -> None:
        if self._verify is not None:
            self._replay_verify(nb.batch)
            return
        batch = nb.batch
        if not nb.long_rows:
            # plain native batch: joins the grouped-fetch lane
            self.seen, pending = self._submit(batch)
            self._group.append((pending, batch))
            if len(self._group) >= self.collect_group:
                self._flush_group()
        else:
            if self._mp_rows is not None:
                raise NotImplementedError(
                    "long reads (> max_len) are not yet supported in the "
                    "multi-process data-parallel driver; raise max_len or "
                    "run the sample queue split instead"
                )
            for r in nb.long_rows:
                batch.lengths[r] = 0  # placeholder row: long path below
            self._flush_group()  # account order = read order
            self.seen, pending = self.clf.submit_batch(self.seen, batch)
            self._inflight.append(
                self._collector.submit(self._drain_job, pending, nb)
            )
        while len(self._inflight) > self.pipeline_depth:
            self._inflight.popleft().result()

    def _barrier(self) -> None:
        """Wait for every queued collector job (order/exception barrier)."""
        self._flush_group()
        while self._inflight:
            self._inflight.popleft().result()

    def _drain_job(self, pending, nb) -> None:
        self.seen_ovr, finals = self.clf.collect(self.seen_ovr, pending)
        batch = nb.batch
        metas = batch.metas
        if not nb.long_rows:
            self._account_batch(finals[: batch.n_rows], metas)
            return
        # resolve all of this batch's long reads in one aggregated pass
        # (chunks from many reads share device planes — one roundtrip per
        # ~batch_size chunks); seen-scatter is a set union, so interleaving
        # with queued batches is safe, and account order stays exact
        long_items = [
            LongRead(meta=metas[i], codes=metas.seq_codes(i, self.cfg.u_is_t))
            for i in nb.long_rows
        ]
        if hasattr(self.clf, "process_long_many"):
            self.seen_ovr, long_finals = self.clf.process_long_many(
                self.seen_ovr, long_items
            )
        else:
            long_finals = []
            for item in long_items:
                self.seen_ovr, f = self.clf.process_long(self.seen_ovr, item)
                long_finals.append(f)
        long_map = dict(zip(nb.long_rows, long_finals))
        for i in range(batch.n_rows):
            if i in long_map:
                self._account(int(long_map[i]), metas[i])
            else:
                self._account(int(finals[i]), None, metas, i)

    def _replay_verify(self, batch) -> None:
        """Exact minalign>0 replay (engine/verify.py) — sequential by design."""
        from kmer_id_tpu.engine.verify import replay_read

        v = self._verify
        self.seen, detail, keys = self.clf.detail_batch(self.seen, batch)
        metas = batch.metas
        for i in range(batch.n_rows):
            meta = metas[i]
            full_len = meta.full_len if meta.full_len >= 0 else len(meta.trimmed_seq)
            final = replay_read(
                self.clf.taxonomy, self.clf.packed_db, detail[i],
                meta.trimmed_seq, full_len, v["verifier"],
                self.gcount, v["ucount"], v["kmer_seen"], keys[i],
                trim_start=meta.trim_start,
            )
            self._account(final, meta)

    def _account_batch(self, finals: np.ndarray, metas) -> None:
        """Vectorized per-batch accounting (common no-long-reads case).

        Equivalent to calling _account row by row: the first-SAVENUM capture
        decision for row i depends on gcount[final] counting *earlier* rows
        only, reconstructed via per-target within-batch ranks.
        """
        cfg = self.cfg
        finals = np.asarray(finals, dtype=np.int64)
        n = len(finals)
        valid = (finals >= 0) & (finals < len(self.gcount))
        f = finals[valid]
        want_main = (
            self.reads_out is not None
            and (cfg.variant == "nx" or cfg.save_target == 0)
        )
        want_target = self.target_reads_out is not None and cfg.save_target > 1
        if want_main or want_target:
            gt1 = np.nonzero(valid & (finals > 1))[0]
            if len(gt1):
                ff = finals[gt1]
                order = np.argsort(ff, kind="stable")
                sf = ff[order]
                first = np.concatenate([[0], np.nonzero(sf[1:] != sf[:-1])[0] + 1])
                starts = np.zeros(len(sf), dtype=np.int64)
                starts[first] = np.arange(len(sf))[first]
                np.maximum.accumulate(starts, out=starts)
                rank = np.arange(len(sf)) - starts  # occurrences before, in batch
                rank_unsorted = np.empty(len(sf), dtype=np.int64)
                rank_unsorted[order] = rank
                before = self.gcount[ff] + rank_unsorted
                main_set = set(
                    gt1[(before < cfg.savenum)].tolist() if want_main else ()
                )
                targ_set = set(
                    gt1[ff == cfg.save_target].tolist() if want_target else ()
                )
                for i in sorted(main_set | targ_set):
                    meta = metas[int(i)]
                    line = f">{finals[i]}:{meta.acc}\n{meta.trimmed_seq}\n"
                    if i in main_set:
                        self.reads_out.write(line)
                    if i in targ_set:
                        self.target_reads_out.write(line)
        np.add.at(self.gcount, f, 1)
        self.reads += n

    def _account(self, final: int, meta, metas=None, i: int = -1) -> None:
        """Saved-read capture + gcount, in read order (newkmer_10nx.cpp:608-613)."""
        cfg = self.cfg
        if final > 1 and final < len(self.gcount):
            save_main = (
                self.reads_out is not None
                and self.gcount[final] < cfg.savenum
                and (cfg.variant == "nx" or cfg.save_target == 0)
            )
            save_target = (
                self.target_reads_out is not None and final == cfg.save_target
            )
            if save_main or save_target:
                if meta is None:
                    meta = metas[i]
                line = f">{final}:{meta.acc}\n{meta.trimmed_seq}\n"
                if save_main:
                    self.reads_out.write(line)
                if save_target:
                    self.target_reads_out.write(line)
        if 0 <= final < len(self.gcount):
            self.gcount[final] += 1
        self.reads += 1


def write_result(path: str, result: SampleResult) -> None:
    """``<sample>_result.txt``: one ``t,gcount,ucount`` line per target
    (``newkmer_10nx.cpp:1040-1043``)."""
    with open(path, "w") as f:
        for i in range(len(result.gcount)):
            f.write(f"{i},{result.gcount[i]},{result.ucount[i]}\n")


# ----------------------------------------------------------------- drivers


def _is_main_process() -> bool:
    """True on the output-writing process (process 0 under jax.distributed;
    always True single-process).  Multi-process drivers run the identical
    sample loop everywhere — collectives require it — but only the main
    process writes result/reads files and the resume manifest."""
    import jax

    return jax.process_count() == 1 or jax.process_index() == 0


def run_nx(
    fastq_dir: str,
    db: LoadedDB,
    cfg: ClassifyConfig | None = None,
    e1: str = "_R1_tr.fastq.gz",
    e2: str = "_R2_tr.fastq.gz",
    fasta_mode: bool = False,
    resume: bool = False,
    clf: Classifier | None = None,
    metrics_path: str | None = None,
) -> list[str]:
    """Batch-classify every paired sample in a directory (nx driver,
    ``newkmer_10nx.cpp:915-1054``).  Returns the processed sample prefixes.

    ``metrics_path``: optional JSONL file for per-sample metrics; metrics are
    written only when requested (no hidden side-effect files in the user's
    data directory)."""
    cfg = cfg or ClassifyConfig.preset("nx")
    clf = clf or make_classifier(db, cfg)
    import jax as _jax

    main = _is_main_process()
    prefixes = []
    for name in os.listdir(fastq_dir):
        pos = name.find(e1)
        if pos != -1:
            prefixes.append(name[:pos])
    if _jax.process_count() > 1:
        prefixes.sort()  # every process must walk samples in the same order
    manifest_path = os.path.join(fastq_dir, ".kmer_id_tpu_done.json")
    done: set[str] = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            done = set(json.load(f))
    processed = []
    for prefix in prefixes:
        if prefix in done:
            log(f"sample {prefix}: already done, skipping (resume)")
            continue
        rpath = os.path.join(fastq_dir, prefix + "_reads.txt")
        with open(rpath if main else os.devnull, "w") as reads_out:
            sp = SampleProcessor(clf, cfg, reads_out=reads_out if main else None)
            if fasta_mode:
                sp.feed_file(os.path.join(fastq_dir, prefix + e1), fmt="fasta")
            else:
                sp.feed_file(os.path.join(fastq_dir, prefix + e1), fmt="fastq_gz")
                r2 = os.path.join(fastq_dir, prefix + e2)
                if os.path.exists(r2):
                    sp.feed_file(r2, fmt="fastq_gz")
            result = sp.finish()
        if main:
            write_result(os.path.join(fastq_dir, prefix + "_result.txt"), result)
        log(f"sample {prefix}: {result.reads} reads")
        if metrics_path and main:
            from kmer_id_tpu.utils.timing import write_metrics_json

            write_metrics_json(
                metrics_path,
                sample=prefix, reads=result.reads, wall_s=round(result.wall_s, 3),
                reads_per_s=round(result.reads / max(result.wall_s, 1e-9), 1),
                classified=int(result.reads - result.gcount[0]),
                stages=result.stage_s,
            )
        done.add(prefix)
        if main:
            with open(manifest_path, "w") as f:
                json.dump(sorted(done), f)
        processed.append(prefix)
    return processed


def load_jobs(jfile: str) -> tuple[list[str], list[list[str]]]:
    """Parse a vf6 job file (``kmer_read_vf6.cpp:1021-1057``), including the
    zero-file-job quirk: a job with 0 files keeps its name in the list but the
    next job's files land in its slot."""
    jnames: list[str] = []
    fnames: list[list[str]] = []
    num_jobs = 0
    with open(jfile, "r", newline="") as f:
        lines = iter(f)
        for line in lines:
            line = line.rstrip("\r\n")
            if len(line) <= 1:
                continue
            parts = line.split()
            jname, j = parts[0], int(parts[1])
            jnames.append(jname)
            fnames.append([])
            for _ in range(j):
                fl = next(lines).rstrip("\r\n")
                fnames[num_jobs].append(fl.split()[0])
            if j > 0:
                num_jobs += 1
    return jnames[:num_jobs], fnames[:num_jobs]


def run_vf6(
    name: str,
    jname: str,
    db: LoadedDB,
    cfg: ClassifyConfig | None = None,
    root: str = ".",
    clf: Classifier | None = None,
) -> list[str]:
    """Job-based classification (vf6 driver, ``kmer_read_vf6.cpp:966-1172``)."""
    cfg = cfg or ClassifyConfig.preset("vf6")
    clf = clf or make_classifier(db, cfg)
    jdir = os.path.join(root, jname)
    jnames, fnames = load_jobs(os.path.join(jdir, jname + ".txt"))
    log(f"{len(jnames)} jobs")
    main = _is_main_process()
    for jstr, files in zip(jnames, fnames):
        r_out = open(os.path.join(jdir, jstr + "_reads.txt"), "w") if main else None
        t_out = (
            open(os.path.join(jdir, jstr + "_target_reads.txt"), "w")
            if cfg.save_target > 0 and main
            else None
        )
        try:
            sp = SampleProcessor(clf, cfg, reads_out=r_out, target_reads_out=t_out)
            for fl in files:
                sp.feed_file(fl)
            result = sp.finish()
        finally:
            if r_out:
                r_out.close()
            if t_out:
                t_out.close()
        if main:
            write_result(os.path.join(jdir, jstr + "_result.txt"), result)
        log(f"job {jstr}: {result.reads} reads")
    return jnames


def run_m3(
    wdir: str,
    f1: str,
    f2: str = "none",
    cfg: ClassifyConfig | None = None,
    db: LoadedDB | None = None,
    db_prefix: str = "mitochondria_",
) -> SampleResult:
    """Single-sample mitochondrial classification (m3 driver,
    ``kmer_read_m3.cpp:973-1132``).  Writes ``wdir/result.txt``."""
    cfg = cfg or ClassifyConfig.preset("m3")
    wdir = wdir if wdir.endswith("/") or wdir == "" else wdir + "/"
    if db is None:
        db = load_db(
            wdir + db_prefix + "data.txt",
            wdir + db_prefix + "tree.txt",
            wdir + db_prefix + "probes.txt.gz",
            require_tree=True,
        )
    if db.kmers_loaded >= 0 and db.kmers_loaded < 2:
        raise SystemExit(1)  # kmer_read_m3.cpp:1067
    clf = make_classifier(db, cfg)
    sp = SampleProcessor(clf, cfg)  # m3 writes no read-capture files
    sp.feed_file(f1)
    if len(f2) > 1 and f2 != "none":
        sp.feed_file(f2)
    result = sp.finish()
    write_result(os.path.join(wdir, "result.txt"), result)
    return result
