"""Pure-Python simulator of the reference classifier (test oracle).

Models the observable pipeline of ``newkmer_10nx.cpp``/``kmer_read_vf6.cpp``
(process_qual → process_read → counters/saved-reads) with the scalar oracles,
so the device engines can be checked end-to-end without compiling the C++.
"""

from __future__ import annotations

from tests.oracles import KSIZE, fold_ref, msca_ref, rolling_kmers, trim_ref


class RefSim:
    def __init__(self, probes: dict[int, int], parent: list[int], num_targ: int,
                 u_is_t: bool = False, savenum: int = 12, save_target: int = 0,
                 variant: str = "vf6"):
        self.probes = probes  # canonical key -> target
        self.parent = parent
        self.num_targ = num_targ
        self.u_is_t = u_is_t
        self.savenum = savenum
        self.save_target = save_target
        self.variant = variant
        self.gcount = [0] * num_targ
        self.ucount = [0] * num_targ
        self.kmer_seen: set[int] = set()
        self.saved: list[tuple[int, str, str]] = []
        self.saved_target: list[tuple[int, str, str]] = []
        self.reads = 0

    def process_read(self, seq: str, acc: str, start: int, stop: int) -> int:
        final = 0
        for _, _, _, key in rolling_kmers(seq[start : stop + 1], u_is_t=self.u_is_t):
            target = self.probes.get(key, 0)
            if final > 0 and target > 0:
                final = msca_ref(self.parent, target, final)
            elif target > 0:
                final = target
            if target > 1:
                if key not in self.kmer_seen:
                    self.ucount[target] += 1
                    self.kmer_seen.add(key)
        trimmed = seq[start : stop + 1]
        if final > 1 and self.gcount[final] < self.savenum:
            if self.variant == "nx" or self.save_target == 0:
                self.saved.append((final, acc, trimmed))
        if final > 1 and final == self.save_target:
            self.saved_target.append((final, acc, trimmed))
        self.gcount[final] += 1
        self.reads += 1
        return final

    def feed(self, records) -> list[int]:
        finals = []
        for acc, seq, qual in records:
            if qual is not None:
                start, stop, keep = trim_ref(qual)
                if keep:
                    finals.append(self.process_read(seq, acc, start, stop))
            else:
                if len(seq) > KSIZE:
                    finals.append(self.process_read(seq, acc, 0, len(seq) - 1))
        return finals

    def result_lines(self) -> list[str]:
        return [f"{i},{self.gcount[i]},{self.ucount[i]}" for i in range(self.num_targ)]
