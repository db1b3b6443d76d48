"""kmer_id_tpu — a JAX metagenomic read classifier.

A from-scratch JAX/XLA framework with the capabilities of the
``mmammel8/kmer_id`` reference (see SURVEY.md): discriminative 30-mer probe
database construction, streaming FASTQ/FASTA classification with
most-specific-common-ancestor taxonomy voting, and abundance report rollups —
redesigned for a data-parallel accelerator (an NVIDIA H100) rather than
translated from the reference C++.

Layer map (mirrors SURVEY.md §1):

* ``core``    — genomic bit-ops (2-bit codec, canonical k-mers), taxonomy
                (vectorized MSCA via ancestor-at-depth tables), quality trim.
* ``ops``     — device kernels: k-mer extraction, fingerprint candidate
                lookup, rank-compaction candidate selection (ops/compact.py),
                sorted two-word binary-search lookup, ordered MSCA fold.
* ``db``      — probe database: text format parity, packed sorted artifact,
                sort-based builder (pass1 CA-merge / pass2 outgroup subtraction
                / pass3 gated emission with entropy filter).
* ``io``      — host-side FASTQ/FASTA(.gz) streaming decode and fixed-shape
                batch packing (native C++ fast path + pure-Python fallback).
* ``engine``  — the jitted classification pipeline, per-sample drivers
                (nx/vf6/m3 presets), sharded execution over a device mesh.
* ``report``  — readbatch_10/readbatch_c3/kmer_read_m3/kmer_readc-compatible
                CSV rollups (bit-identical formatting).
* ``parallel``— mesh construction, data-parallel and DB-sharded classify
                steps, collectives.
"""

__version__ = "0.1.0"

KSIZE = 30  # k-mer size; reference newkmer_10nx.cpp:43
