"""Fixed-shape batch packing for the jitted classifier.

Variable-length ragged reads become static [batch, max_len] uint8 code planes
(pad code 4 = invalid), the shape XLA compiles once per (B, L).  Quality
trimming runs vectorized over a staging buffer (core/trim.py) rather than
per-read; only reads passing the reference's gates (trim keep for FASTQ,
length > KSIZE for FASTA — ``newkmer_10nx.cpp:755,849``) occupy rows, so
dropped reads never touch the device, never count toward gcount/tct, exactly
like the reference's early returns.

Reads longer than ``max_len`` (FASTA contigs / long-read data) are emitted as
:class:`LongRead` items instead of rows: the engine scans their chunk planes
(with a KSIZE-1 halo so no window is lost or duplicated at chunk joins) and
folds hits exactly; see engine/classify.py.  Items are yielded strictly in
read order, preserving the order-dependent saved-read capture semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from kmer_id_tpu.core.codec import KSIZE, CODE_LUT, CODE_LUT_U, INVALID
from kmer_id_tpu.core.trim import trim_batch


@dataclass
class RowMeta:
    acc: str
    trimmed_seq: str  # seq[start : stop+1] — the saved-read payload
    # Alignment-verify replay needs full-read coordinates: the reference's
    # minscr uses the UNtrimmed length (newkmer_10nx.cpp:474) and its k-mer
    # end index it1 counts from the full sequence start (:475,532).
    full_len: int = -1  # len(seq) before trimming; -1 = len(trimmed_seq)
    trim_start: int = 0  # index of trimmed_seq[0] within the full sequence


@dataclass
class Batch:
    codes: np.ndarray  # uint8 [B, L]
    lengths: np.ndarray  # int32 [B]
    metas: list[Optional[RowMeta]]  # None for padding rows
    n_rows: int
    # Transfer-light representation (engine/fpclassify.py): 2-bit packed
    # words + sparse non-ACGT exception list, ~4x fewer host->device bytes
    # than ``codes``; only these cross to the device when present, and
    # ``codes`` stays host-side for long-read replay.
    packed: Optional[np.ndarray] = None  # uint32 [B, ceil(L/16)]
    exc: Optional[np.ndarray] = None  # int32 [EXC_CAP]; flat row*L+pos, -1 pad


EXC_CAP = 1024  # static exception-list shape (one jit signature); batches
# with more in-length non-ACGT bases ship the u8 plane instead (rare)

_PACK_SHIFTS = (np.uint32(2) * np.arange(16, dtype=np.uint32)).reshape(1, 1, 16)


def pack_codes(codes: np.ndarray, lengths: np.ndarray):
    """uint8 code plane -> (packed u32 [B, ceil(L/16)], exc int32 [EXC_CAP]).

    Inverse of engine/fpclassify.unpack_codes.  Returns (None, None) when the
    batch has more than EXC_CAP in-length invalid bases (caller falls back to
    shipping the plane).  Bases beyond a row's length pack as garbage 0..3 —
    harmless, the extract kernel masks them by length.
    """
    b, l = codes.shape
    w = (l + 15) // 16
    bad = codes >= 4
    if bad.any():
        inlen = np.arange(l, dtype=np.int32)[None, :] < lengths[:, None]
        excm = bad & inlen
        n_exc = int(excm.sum())
        if n_exc > EXC_CAP:
            return None, None
        exc = np.full(EXC_CAP, -1, dtype=np.int32)
        if n_exc:
            exc[:n_exc] = np.flatnonzero(excm).astype(np.int32)
    else:
        exc = np.full(EXC_CAP, -1, dtype=np.int32)
    c = codes
    if l != w * 16:
        c = np.zeros((b, w * 16), dtype=np.uint8)
        c[:, :l] = codes
    c32 = (c & np.uint8(3)).astype(np.uint32).reshape(b, w, 16)
    packed = np.bitwise_or.reduce(c32 << _PACK_SHIFTS, axis=2)
    return packed, exc


@dataclass
class LongRead:
    meta: RowMeta
    codes: np.ndarray  # uint8 [TL] trimmed, encoded


@dataclass
class _Staged:
    acc: str
    seq: str
    qual: Optional[str]


class ReadBatcher:
    """Order-preserving packer: records in → Batch / LongRead items out."""

    def __init__(
        self,
        batch_size: int = 1024,
        max_len: int = 512,
        u_is_t: bool = False,
        stage_factor: int = 4,
    ):
        if max_len < KSIZE + 1:
            raise ValueError(f"max_len must be > KSIZE={KSIZE}")
        self.batch_size = batch_size
        self.max_len = max_len
        self.lut = CODE_LUT_U if u_is_t else CODE_LUT
        self.stage_cap = batch_size * stage_factor
        self._staged: list[_Staged] = []
        self._rows: list[tuple[np.ndarray, RowMeta] | LongRead] = []

    # ---------------------------------------------------------------- feed
    def add(self, acc: str, seq: str, qual: Optional[str]) -> Iterator[Batch | LongRead]:
        self._staged.append(_Staged(acc, seq, qual))
        if len(self._staged) >= self.stage_cap:
            yield from self._drain(final=False)

    def flush(self) -> Iterator[Batch | LongRead]:
        yield from self._drain(final=True)

    # ------------------------------------------------------------ internals
    def _drain(self, final: bool) -> Iterator[Batch | LongRead]:
        self._trim_staged()
        yield from self._emit(final)

    def _trim_staged(self) -> None:
        staged, self._staged = self._staged, []
        if not staged:
            return
        fq = [s for s in staged if s.qual is not None]
        bounds: dict[int, tuple[int, int, bool]] = {}
        if fq:
            maxl = max(len(s.qual) for s in fq)
            q = np.zeros((len(fq), maxl), dtype=np.uint8)
            lens = np.zeros(len(fq), dtype=np.int64)
            for i, s in enumerate(fq):
                qb = s.qual.encode("latin-1", errors="replace")
                q[i, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
                lens[i] = max(1, len(qb))
            start, stop, keep = trim_batch(q, lens)
            for i, s in enumerate(fq):
                bounds[id(s)] = (int(start[i]), int(stop[i]), bool(keep[i]))
        for s in staged:
            if s.qual is not None:
                b0, b1, keep = bounds[id(s)]
                if not keep:
                    continue
            else:
                # FASTA gate: sequence length must exceed KSIZE
                if len(s.seq) <= KSIZE:
                    continue
                b0, b1 = 0, len(s.seq) - 1
            sub = s.seq[b0 : b1 + 1]
            codes = self.lut[np.frombuffer(sub.encode("latin-1", "replace"), np.uint8)]
            meta = RowMeta(
                acc=s.acc, trimmed_seq=sub, full_len=len(s.seq), trim_start=b0
            )
            if len(codes) > self.max_len:
                self._rows.append(LongRead(meta=meta, codes=codes))
            else:
                self._rows.append((codes, meta))

    def _emit(self, final: bool) -> Iterator[Batch | LongRead]:
        pend: list[tuple[np.ndarray, RowMeta]] = []

        def make_batch(rows) -> Batch:
            b = self.batch_size
            codes = np.full((b, self.max_len), INVALID, dtype=np.uint8)
            lengths = np.zeros(b, dtype=np.int32)
            metas: list[Optional[RowMeta]] = [None] * b
            for i, (c, m) in enumerate(rows):
                codes[i, : len(c)] = c
                lengths[i] = len(c)
                metas[i] = m
            packed, exc = pack_codes(codes, lengths)
            return Batch(codes=codes, lengths=lengths, metas=metas,
                         n_rows=len(rows), packed=packed, exc=exc)

        rows, self._rows = self._rows, []
        for item in rows:
            if isinstance(item, LongRead):
                # Flush pending rows first so items stay in read order.
                if pend:
                    yield make_batch(pend)
                    pend = []
                yield item
            else:
                pend.append(item)
                if len(pend) == self.batch_size:
                    yield make_batch(pend)
                    pend = []
        if final and pend:
            yield make_batch(pend)
        else:
            self._rows = list(pend)
