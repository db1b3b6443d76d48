"""Device-side canonical k-mer extraction from packed read batches.

Data-parallel reformulation of the reference's per-character rolling-key loop
(``newkmer_10nx.cpp:475-528``): instead of a sequential (keyF, keyR, cpos)
automaton, every sliding window's two key words are computed as 30 unrolled
shifted adds over the whole [batch, length] code plane (elementwise work
that XLA fuses), and window validity falls out of a prefix-sum over the
invalid-base indicator.  Semantics are identical: a k-mer is emitted at every
position whose trailing 30 bases are valid, and any non-ACGT base invalidates
exactly the windows containing it (the reference's ``cpos = 0`` reset).

Keys are carried as two uint32 words — hi = bits [32, 60), lo = bits [0, 32)
— (core/codec.py: the device path stays 32-bit).  Comparisons downstream
are lexicographic on (hi, lo).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kmer_id_tpu.core.codec import KSIZE

# Forward key: base j (0 = leftmost of the window) contributes
#   code << (2*(KSIZE-1-j))   -> bits >= 32 iff j <= 13.
# Reverse-complement key: base j contributes (3-code) << (2*j)
#   -> bits >= 32 iff j >= 16.
_F_HI = [(j, 2 * (KSIZE - 1 - j) - 32) for j in range(KSIZE) if 2 * (KSIZE - 1 - j) >= 32]
_F_LO = [(j, 2 * (KSIZE - 1 - j)) for j in range(KSIZE) if 2 * (KSIZE - 1 - j) < 32]
_R_HI = [(j, 2 * j - 32) for j in range(KSIZE) if 2 * j >= 32]
_R_LO = [(j, 2 * j) for j in range(KSIZE) if 2 * j < 32]


def extract_kmers(codes: jax.Array, lengths: jax.Array):
    """Canonical (hi, lo) keys for every window of a packed read batch.

    Args:
      codes: uint8 [B, L]; 0..3 = A,C,G,T, >=4 = invalid/padding.
      lengths: int32 [B]; valid prefix length of each row.

    Returns:
      dict with
        ``hi``, ``lo``: uint32 [B, P] canonical key words (P = L-KSIZE+1),
        ``valid``: bool [B, P] — window fully in-bounds and all bases valid,
        ``fstrand``: bool [B, P] — forward key strictly below the
        reverse-complement key (``keyF < keyR``, newkmer_10nx.cpp:528).
      Window s covers codes[:, s:s+KSIZE]; its end position is s+KSIZE-1,
      so ascending s matches the reference's per-base emission order.
    """
    b, l = codes.shape
    p = l - KSIZE + 1
    if p <= 0:
        raise ValueError(f"batch length {l} shorter than KSIZE={KSIZE}")
    c = codes.astype(jnp.uint32)
    inb = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1) < lengths[:, None]
    bad = ((codes >= 4) | ~inb).astype(jnp.int32)

    fhi = jnp.zeros((b, p), dtype=jnp.uint32)
    flo = jnp.zeros((b, p), dtype=jnp.uint32)
    rhi = jnp.zeros((b, p), dtype=jnp.uint32)
    rlo = jnp.zeros((b, p), dtype=jnp.uint32)
    three = jnp.uint32(3)
    for j, sh in _F_HI:
        fhi = fhi | ((c[:, j : j + p] & three) << sh)
    for j, sh in _F_LO:
        flo = flo | ((c[:, j : j + p] & three) << sh)
    for j, sh in _R_HI:
        rhi = rhi | (((three - (c[:, j : j + p] & three)) & three) << sh)
    for j, sh in _R_LO:
        rlo = rlo | (((three - (c[:, j : j + p] & three)) & three) << sh)

    # Window validity: zero invalid bases among codes[:, s:s+KSIZE].
    cs = jnp.cumsum(bad, axis=1)
    win_bad = cs[:, KSIZE - 1 :] - jnp.pad(cs, ((0, 0), (1, 0)))[:, :p]
    valid = win_bad == 0

    fwd = (fhi < rhi) | ((fhi == rhi) & (flo < rlo))
    hi = jnp.where(fwd, fhi, rhi)
    lo = jnp.where(fwd, flo, rlo)
    return {"hi": hi, "lo": lo, "valid": valid, "fstrand": fwd}
