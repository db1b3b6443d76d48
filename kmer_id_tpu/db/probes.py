"""Probe database: text-format parity and the packed sorted artifact.

Text format (one CSV line per probe, ``kmer_build_vf6.cpp:625`` emit /
``newkmer_10nx.cpp:695-701`` parse):

    KMERSTRING,target,org,position,strand(F/R),count

``position`` is the 0-based index of the k-mer's last base in the org's
concatenated genome.  The reference loads this text into a 24 GiB
open-addressing hash at startup (minutes of parse + page faults,
``newkmer_10nx.cpp:988``); the device layout is a *packed artifact*: keys
sorted as uint64, split into (hi, lo) uint32 planes for the device, plus
parallel value arrays and a first-level bucket index — written once to a
directory of ``.npy`` files and memory-mapped on load, so startup is I/O-bound
instead of parse-bound.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from kmer_id_tpu.core.codec import (
    CODE_LUT as CODE_LUT_LOCAL,
    KSIZE,
    forward_kmers,
    encode_bases,
    key_to_string,
    split_key,
)

_MAGIC = "kmer_id_tpu.packed_db"
_VERSION = 2


@dataclass
class ProbeRecords:
    """Probe rows in file order (pre-packing)."""

    keys: np.ndarray  # uint64 [M]
    target: np.ndarray  # int32 [M]
    org: np.ndarray  # int32 [M]
    position: np.ndarray  # int32 [M]
    fstrand: np.ndarray  # bool [M]
    count: np.ndarray  # int32 [M]

    def __len__(self) -> int:
        return len(self.keys)


@dataclass
class PackedDB:
    """Sorted flat key/value arrays ready for device upload."""

    keys: np.ndarray  # uint64 [N] sorted ascending, unique
    hi: np.ndarray  # uint32 [N]
    lo: np.ndarray  # uint32 [N]
    target: np.ndarray  # int32 [N]
    org: np.ndarray  # int32 [N]
    position: np.ndarray  # int32 [N]
    fstrand: np.ndarray  # bool [N]
    num_targ: int
    bucket_bits: int = 0
    bucket_off: np.ndarray | None = None  # int32 [2**bucket_bits + 1]
    max_bucket_len: int = 0  # widest bucket; bounds binary-search depth
    _cuckoo: object = None  # lazy CuckooTable (db/cuckoo.py)

    def cuckoo(self):
        """Cuckoo layout for the 2-gather device lookup (built lazily)."""
        if self._cuckoo is None:
            from kmer_id_tpu.db.cuckoo import build_cuckoo

            self._cuckoo = build_cuckoo(self.hi, self.lo, self.target)
        return self._cuckoo

    def __len__(self) -> int:
        return len(self.keys)

    def device_arrays(self) -> dict:
        d = {"hi": self.hi, "lo": self.lo, "target": self.target}
        if self.bucket_bits > 0:
            d["bucket_off"] = self.bucket_off
        return d


def _open_maybe_gz(path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def parse_probes_text(path) -> ProbeRecords:
    """Parse a probes CSV (optionally gzipped), preserving file order.

    Parity notes (``newkmer_10nx.cpp:688-706``): commas are treated as field
    separators alongside whitespace; lines that do not yield all six fields
    are skipped; the k-mer string is *forward re-encoded* with a sliding
    window, so a string longer than 30 valid bases contributes one probe per
    window and invalid characters suppress the windows containing them.

    Regular builder-emitted files (exactly ``30xACGT,int,int,int,F|R,int``
    per line) take a fully vectorized fast path (bytes.translate splits the
    base letters from the numeric fields at C speed; ~50x faster than
    per-line parsing on multi-million-probe DBs); anything irregular falls
    back to the exact per-line parser.
    """
    fast = _parse_probes_fast(path)
    if fast is not None:
        return fast
    return _parse_probes_slow(path)


def _parse_probes_fast(path) -> ProbeRecords | None:
    with _open_maybe_gz(path, "rb") as f:
        data = f.read()
    if not data:
        return None
    if not data.endswith(b"\n"):
        data += b"\n"
    nlines = data.count(b"\n")
    if data.count(b"\r"):
        return None
    # base letters appear only in the k-mer field; F/R/digits/commas do not
    # collide with ACGT
    kmer_blob = data.translate(None, delete=bytes(set(range(256)) - set(b"ACGT")))
    if len(kmer_blob) != KSIZE * nlines:
        return None
    num_blob = (
        data.translate(None, delete=b"ACGT")
        .replace(b",F,", b",0,")
        .replace(b",R,", b",1,")
        .replace(b",", b"\n")
    )
    # each line contributed ",t,o,p,s,c" -> after joins: 6 newline-separated
    # tokens per line with an empty first token; drop empties via fromiter?
    # np.loadtxt skips empty lines, leaving exactly 5 ints per probe line.
    nums = _parse_ints_lines(num_blob)
    if nums is None or nums.size != 5 * nlines:
        return None
    nums = nums.reshape(nlines, 5)
    codes = CODE_LUT_LOCAL[np.frombuffer(kmer_blob, dtype=np.uint8)].reshape(
        nlines, KSIZE
    )
    # accumulate as two uint32 words (SIMD-friendly), then join
    hi = np.zeros(nlines, dtype=np.uint32)
    lo = np.zeros(nlines, dtype=np.uint32)
    for j in range(KSIZE):
        sh = 2 * (KSIZE - 1 - j)
        w = codes[:, j].astype(np.uint32)
        if sh >= 32:
            hi |= w << np.uint32(sh - 32)
        else:
            lo |= w << np.uint32(sh)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo
    return ProbeRecords(
        keys=keys,
        target=nums[:, 0].astype(np.int32),
        org=nums[:, 1].astype(np.int32),
        position=nums[:, 2].astype(np.int32),
        fstrand=nums[:, 3] == 0,
        count=nums[:, 4].astype(np.int32),
    )


def _parse_ints_lines(blob: bytes) -> np.ndarray | None:
    """Vectorized parse of newline-separated non-negative decimal ints.

    Stable replacement for ``np.fromstring(..., sep="\\n")`` (text mode is
    removed in NumPy 2.x, where the old fallback silently degraded to the
    ~4x-slower np.loadtxt — this is the parse hot spot on multi-10M-probe
    DBs).  Empty tokens (from consecutive separators) are skipped, matching
    loadtxt's empty-line behavior.  Returns None on any non-digit byte.
    """
    d = np.frombuffer(blob, dtype=np.uint8)
    if d.size == 0:
        return np.zeros(0, dtype=np.int64)
    nl = d == ord("\n")
    if not nl[-1]:  # ensure a trailing separator so every token has an end
        d = np.concatenate([d, np.array([ord("\n")], dtype=np.uint8)])
        nl = d == ord("\n")
    digits = d - ord("0")
    if not (nl | (digits <= 9)).all():
        return None
    ends = np.flatnonzero(nl)
    starts = np.concatenate([[0], ends[:-1] + 1])
    tok_len = ends - starts
    keep = tok_len > 0
    ends, tok_len = ends[keep], tok_len[keep]
    vals = np.zeros(len(ends), dtype=np.int64)
    dig64 = digits.astype(np.int64)
    place = np.int64(1)
    for p in range(int(tok_len.max(initial=0))):
        has = tok_len > p
        vals[has] += dig64[ends[has] - 1 - p] * place
        place *= 10
    return vals


def _parse_probes_slow(path) -> ProbeRecords:
    keys, targets, orgs, positions, strands, counts = [], [], [], [], [], []
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 6:
                continue
            try:
                kstr = parts[0]
                target = int(parts[1])
                org = int(parts[2])
                position = int(parts[3])
                strand = parts[4]
                count = int(parts[5])
            except ValueError:
                continue
            ks, _ = forward_kmers(encode_bases(kstr))
            for k in ks:
                keys.append(k)
                targets.append(target)
                orgs.append(org)
                positions.append(position)
                strands.append(strand == "F")
                counts.append(count)
    return ProbeRecords(
        keys=np.asarray(keys, dtype=np.uint64),
        target=np.asarray(targets, dtype=np.int32),
        org=np.asarray(orgs, dtype=np.int32),
        position=np.asarray(positions, dtype=np.int32),
        fstrand=np.asarray(strands, dtype=bool),
        count=np.asarray(counts, dtype=np.int32),
    )


def write_probes_text(records: ProbeRecords, path) -> None:
    """Emit probe rows in the reference CSV format (builder output parity).

    Key decoding takes the native batch path when available (db/native
    km_keys_to_str; the per-key python join dominated multi-M-probe emission
    time) — output bytes are identical either way."""
    try:
        from kmer_id_tpu.db.native import keys_to_strings, write_probes

        if write_probes(path, records.keys, records.target, records.org,
                        records.position, records.fstrand, records.count):
            return
        kstrs = keys_to_strings(records.keys)
    except Exception:
        kstrs = None
    with _open_maybe_gz(path, "wt") as f:
        if kstrs is not None:
            strand = np.where(records.fstrand, "F", "R")
            f.writelines(
                f"{kstrs[i].decode()},{records.target[i]},"
                f"{records.org[i]},{records.position[i]},"
                f"{strand[i]},{records.count[i]}\n"
                for i in range(len(records))
            )
            return
        for i in range(len(records)):
            f.write(
                f"{key_to_string(records.keys[i])},{records.target[i]},"
                f"{records.org[i]},{records.position[i]},"
                f"{'F' if records.fstrand[i] else 'R'},{records.count[i]}\n"
            )


def _default_bucket_bits(n: int) -> int:
    """Bucket count ~ n/16 so in-bucket search is a few gather rounds."""
    if n < 1 << 12:
        return 0
    return min(26, max(1, int(np.log2(max(n, 2))) - 4))


def pack_probes(
    records: ProbeRecords, num_targ: int, bucket_bits: int | None = None
) -> PackedDB:
    """Sort by key, dedup keep-first-in-file-order, build the bucket index.

    Keep-first matches reference lookup semantics for duplicate keys: probing
    stops at the first matching cell, which is the earliest insert
    (``newkmer_10nx.cpp:204-233``).
    """
    order = np.argsort(records.keys, kind="stable")
    keys = records.keys[order]
    uniq_mask = np.ones(len(keys), dtype=bool)
    if len(keys) > 1:
        uniq_mask[1:] = keys[1:] != keys[:-1]
    sel = order[uniq_mask]
    keys = records.keys[sel]
    hi, lo = split_key(keys)
    n = len(keys)
    bb = _default_bucket_bits(n) if bucket_bits is None else bucket_bits
    bucket_off = None
    max_bucket_len = n
    if bb > 0:
        # bucket id = top bb bits of the 60-bit key = hi >> (28 - bb)
        bucket = (hi >> np.uint32(28 - bb)).astype(np.int64)
        counts = np.bincount(bucket, minlength=(1 << bb))
        bucket_off = np.zeros((1 << bb) + 1, dtype=np.int32)
        np.cumsum(counts, out=bucket_off[1:])
        max_bucket_len = int(counts.max(initial=0))
    return PackedDB(
        keys=keys,
        hi=hi,
        lo=lo,
        target=records.target[sel].astype(np.int32),
        org=records.org[sel].astype(np.int32),
        position=records.position[sel].astype(np.int32),
        fstrand=records.fstrand[sel].astype(bool),
        num_targ=int(num_targ),
        bucket_bits=bb,
        bucket_off=bucket_off,
        max_bucket_len=max_bucket_len,
    )


# --------------------------------------------------------------- artifact IO

_ARRAYS = ("keys", "hi", "lo", "target", "org", "position", "fstrand")


def save_packed(db: PackedDB, out_dir) -> None:
    """Write a packed DB as a directory of raw .npy planes + manifest.

    Loading memory-maps the planes (np.load mmap) — the analog of
    checkpoint/resume for the DB artifact (SURVEY.md §5): one-time pack,
    near-instant startup afterwards.
    """
    os.makedirs(out_dir, exist_ok=True)
    for name in _ARRAYS:
        np.save(os.path.join(out_dir, f"{name}.npy"), getattr(db, name))
    if db.bucket_off is not None:
        np.save(os.path.join(out_dir, "bucket_off.npy"), db.bucket_off)
    ck = db.cuckoo()
    np.save(os.path.join(out_dir, "cuckoo.npy"), ck.table)
    ck = db.cuckoo()
    manifest = {
        "magic": _MAGIC,
        "version": _VERSION,
        "cuckoo_nb": ck.nb,
        "cuckoo_s1": ck.s1,
        "cuckoo_s2": ck.s2,
        "ksize": KSIZE,
        "num_probes": len(db),
        "num_targ": db.num_targ,
        "bucket_bits": db.bucket_bits,
        "max_bucket_len": db.max_bucket_len,
        "key_digest": hashlib.sha256(db.keys.tobytes()).hexdigest()[:16],
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_packed(in_dir, mmap: bool = True) -> PackedDB:
    with open(os.path.join(in_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("magic") != _MAGIC:
        raise ValueError(f"{in_dir} is not a packed kmer DB")
    mode = "r" if mmap else None
    arrs = {
        name: np.load(os.path.join(in_dir, f"{name}.npy"), mmap_mode=mode)
        for name in _ARRAYS
    }
    bb = int(manifest["bucket_bits"])
    bucket_off = (
        np.load(os.path.join(in_dir, "bucket_off.npy"), mmap_mode=mode) if bb > 0 else None
    )
    cuckoo = None
    ck_path = os.path.join(in_dir, "cuckoo.npy")
    if "cuckoo_nb" in manifest and os.path.exists(ck_path):
        from kmer_id_tpu.db.cuckoo import CuckooTable

        cuckoo = CuckooTable(
            table=np.load(ck_path, mmap_mode=mode),
            nb=int(manifest["cuckoo_nb"]),
            s1=int(manifest["cuckoo_s1"]),
            s2=int(manifest["cuckoo_s2"]),
        )
    return PackedDB(
        num_targ=int(manifest["num_targ"]),
        bucket_bits=bb,
        bucket_off=bucket_off,
        max_bucket_len=int(manifest.get("max_bucket_len", 0)),
        _cuckoo=cuckoo,
        **arrs,
    )
