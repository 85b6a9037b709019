"""Pure-Python sequential oracle of the reference algorithm (collision-free
regime): used to validate the batched device implementation on arbitrary inputs.

Reimplements, from the reference's semantics (not its code): N->A rewrite
(normalise_kmers_multi_large.c:1406), 2-bit encode (:1118-1126), canonical
min(fwd, revcomp) (:1175-1180), poly-A drop (:1483), upsert-then-test counting
(:929-1053,:1494), ratio with total==0 -> 0 (:1641-1642), strict < coverage keep
(:1646), pair AND rule, and seeding with count 0 / len>k (:1322-1373).
"""
from __future__ import annotations

_MAP = {"A": 0, "C": 1, "G": 2, "T": 3}


def encode(kmer: str) -> int:
    code = 0
    for ch in kmer:
        code = (code << 2) | _MAP[ch]
    return code


def revcomp(seq: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(seq))


class Oracle:
    def __init__(self, k: int, depth: int, coverage: float, canonical: bool = False,
                 stride: int = 1):
        self.k = k
        self.stride = stride  # count every stride-th window (engine --stride)
        self.depth = depth
        self.coverage = coverage
        self.canonical = canonical
        self.counts: dict[int, int] = {}
        self.seeded: set[int] = set()

    def _codes(self, seq: str):
        seq = seq.replace("N", "A")
        k = self.k
        for i in range(0, len(seq) - k + 1, self.stride):
            km = seq[i: i + k]
            if self.canonical:
                rc = revcomp(km)
                km = min(km, rc)
            code = encode(km)
            if code == 0:
                continue
            yield code

    def seed_seq(self, seq: str):
        seq = seq.replace("N", "A")
        if len(seq) <= self.k:  # strictly greater rule (:1347)
            return
        for code in self._codes(seq):
            self.counts.setdefault(code, 0)
            self.seeded.add(code)

    def _tally(self, seq: str) -> tuple[int, int]:
        high = total = 0
        for code in self._codes(seq):
            total += 1
            c = self.counts.get(code, 0) + 1
            self.counts[code] = c
            if c >= self.depth:
                high += 1
        return high, total

    @staticmethod
    def _ratio(high: int, total: int) -> float:
        return high / total if total > 0 else 0.0

    def process_single(self, seq: str):
        """Returns keep (True/False) or None if the record is invalid (len<k)."""
        s = seq.replace("N", "A")
        if len(s) < self.k:
            return None
        high, total = self._tally(s)
        return self._ratio(high, total) < self.coverage

    def process_pair(self, fwd: str, rev: str):
        f, r = fwd.replace("N", "A"), rev.replace("N", "A")
        if len(f) < self.k or len(r) < self.k:
            return None
        hf, tf = self._tally(f)
        hr, tr = self._tally(r)
        return (
            self._ratio(hf, tf) < self.coverage
            and self._ratio(hr, tr) < self.coverage
        )

    def unique_kmers(self) -> int:
        return len(self.counts)
