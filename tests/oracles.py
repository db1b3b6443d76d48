"""Brute-force scalar oracles for property tests.

These transliterate the *behavioral spec* extracted from the reference
(SURVEY.md §2.2 with file:line citations) as straight-line Python: slow,
obviously-correct models that the vectorized device implementations are tested
against.  They are test-only code.
"""

from __future__ import annotations

KSIZE = 30
MASK = (1 << (2 * KSIZE)) - 1
HI_SHIFT = 2 * (KSIZE - 1)

_CODE = {c: i for i, c in enumerate("ACGT")}
_CODE.update({c.lower(): i for i, c in enumerate("ACGT")})


def rolling_kmers(seq: str, u_is_t: bool = False, canonical: bool = True):
    """Per-base rolling-key automaton (newkmer_10nx.cpp:452-528 semantics).

    Yields (end_pos, keyF, keyR, canonical_key) for each emitted k-mer.
    """
    code = dict(_CODE)
    if u_is_t:
        code["U"] = 3
        code["u"] = 3
    keyF = keyR = 0
    cpos = 0
    out = []
    for i, ch in enumerate(seq):
        c = code.get(ch)
        if c is None:
            cpos = 0
            keyF = keyR = 0
        else:
            keyF = ((keyF << 2) & MASK) | c
            keyR = (keyR >> 2) | ((3 - c) << HI_SHIFT)
            cpos += 1
        if cpos == KSIZE:
            key = keyF if keyF < keyR else keyR
            out.append((i, keyF, keyR, key))
            cpos -= 1
    return out


def msca_ref(parent: list[int], x: int, y: int, root: int = 1) -> int:
    """Classifier msca set-walk (newkmer_10nx.cpp:118-144)."""

    def get_parent(z):
        return parent[z] if (z != root and z > 0) else root

    ancestors = {root}
    z = x
    while z != root:
        ancestors.add(z)
        z = get_parent(z)
    if y in ancestors:
        return x
    z = y
    while z not in ancestors:
        z = get_parent(z)
        if z == x:
            return y
    return z


def ca_ref(parent: list[int], x: int, y: int) -> int:
    """Builder ca set-walk (kmer_build_vf6.cpp:99-118)."""
    ancestors = {1}
    z = x
    while z > 1:
        ancestors.add(z)
        z = parent[z]
    z = y
    while z not in ancestors:
        z = parent[z]
    return z


def fold_ref(parent: list[int], targets: list[int]) -> int:
    """Sequential per-read fold (newkmer_10nx.cpp:588-595)."""
    final = 0
    for t in targets:
        if t > 0:
            final = msca_ref(parent, t, final) if final > 0 else t
    return final


def trim_ref(qual: str) -> tuple[int, int, bool]:
    """process_qual trim loops (newkmer_10nx.cpp:714-760)."""
    cutoff = 49
    w = 4
    wcut = 17 * w
    stop = len(qual) - 1
    start = 0
    q = [ord(c) for c in qual]
    while q[start] < cutoff and start < stop:
        start += 1
    while q[stop] < cutoff and stop > start:
        stop -= 1
    if start < stop - w:
        wv = sum(q[start + i] - 32 for i in range(w))
        while wv < wcut and start < stop - w:
            wv += q[start + w] - q[start]
            start += 1
    if start < stop - w:
        wv = sum(q[stop - i] - 32 for i in range(w))
        while wv < wcut and start < stop - w:
            wv += q[stop - w] - q[stop]
            stop -= 1
    return start, stop, (stop - start) >= KSIZE


def check_entropy_ref(kmer: str) -> bool:
    """Entropy/homopolymer probe filter (kmer_build_vf6.cpp:460-551)."""
    import math

    counts = [[1.0] * 4 for _ in range(10)]  # [bucket][base] with pseudocount
    prev = "N"
    row = 0
    maxrow = 0
    for i, ch in enumerate(kmer):
        if ch == prev:
            row += 1
            maxrow = max(maxrow, row)
        else:
            row = 1
            prev = ch
        b = _CODE.get(ch)
        if b is not None and ch in "ACGT":
            counts[i % 2][b] += 1.0
            counts[i % 3 + 2][b] += 1.0
            counts[i % 5 + 5][b] += 1.0
    if maxrow > 11:
        return False
    ent = []
    for i in range(10):
        tot = sum(counts[i])
        e = 0.0
        for b in range(4):
            p = counts[i][b] / tot
            e -= p * math.log10(p)
        ent.append(e)
    l4 = math.log10(4.0)
    e2 = (ent[0] + ent[1]) / 2.0 / l4
    e3 = (ent[2] + ent[3] + ent[4]) / 3.0 / l4
    e5 = (ent[5] + ent[6] + ent[7] + ent[8] + ent[9]) / 5.0 / l4
    return not (e2 < 0.80 or e3 < 0.80 or e5 < 0.80)
