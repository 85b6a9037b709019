"""End-to-end output parity vs the reference binary (golden captures).

Golden data in tests/golden/ was produced by running the compiled reference
(each case's argv is in its args.txt) with the table sized to 4^k (capacity
clamp, parse_arguments :678-684), where the reference's open addressing
degenerates to exact direct-address counting — the regime BASELINE.md's parity
requirement targets. Each case asserts byte-identical kept-read output files
and identical processed/printed/skipped totals.

Inputs live in tests/data: 2seq.fastq is the d100 golden's output (every
record printed); a1/b1.fastq carry the a1/b1.fasta records with the
qualities of the goldens that print them (placeholder qualities elsewhere,
which no golden reads). a2/b2 are not in the repo, so the cases that need
them stay behind the slow marker.
"""
import pathlib
import re

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer

GOLDEN = pathlib.Path(__file__).parent / "golden"
T = pathlib.Path(__file__).parent / "data"


def _golden_stats(case: str):
    txt = (GOLDEN / case / "stdout_stable.txt").read_text()
    m = re.search(r"Processed Records: ([\d,]+)", txt)
    p = re.search(r"Printed Records: ([\d,]+)", txt)
    s = re.search(r"Skipped Records: ([\d,]+)", txt)
    k = re.search(r"Cumulative Max unique kmers in any thread: ([\d,]+)", txt)
    return tuple(int(x.group(1).replace(",", "")) for x in (m, p, s, k))


def _run(cfg: Config):
    n = Normalizer(cfg)
    report = n.run()
    return n, report


def _assert_same_file(ours: pathlib.Path, golden: pathlib.Path):
    assert ours.exists(), f"missing output {ours}"
    a, b = ours.read_bytes(), golden.read_bytes()
    assert a == b, (
        f"{ours.name}: {len(a)} bytes vs golden {len(b)}; "
        f"first diff at {next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))}"
    )


def test_2seq_single_d2(tmp_path):
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=15, depth=2,
        out_dir=str(tmp_path), print_table=True,
    )
    _, report = _run(cfg)
    want = _golden_stats("2seq_single_k15_d2")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    _assert_same_file(
        tmp_path / "output_forward.k15_norm2_thread0.fastq",
        GOLDEN / "2seq_single_k15_d2" / "output_forward.k15_norm2_thread0.fastq",
    )
    # -P dumps: reference slot order == code order in the 4^k direct regime
    _assert_same_file(
        tmp_path / "output_kmer_seeds.k15_norm2.tsv",
        GOLDEN / "2seq_single_k15_d2" / "output_kmer_seeds.k15_norm2.tsv",
    )
    _assert_same_file(
        tmp_path / "output_kmer.k15_norm2_thread0.tsv",
        GOLDEN / "2seq_single_k15_d2" / "output_kmer.k15_norm2_thread0.tsv",
    )


def test_2seq_single_d100(tmp_path):
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=15, depth=100,
        out_dir=str(tmp_path),
    )
    _, report = _run(cfg)
    want = _golden_stats("2seq_single_k15_d100")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    _assert_same_file(
        tmp_path / "output_forward.k15_norm100_thread0.fastq",
        GOLDEN / "2seq_single_k15_d100" / "output_forward.k15_norm100_thread0.fastq",
    )


@pytest.mark.parametrize("case,canonical", [
    ("a1b1_paired_k15_d4", False),
    ("a1b1_canon_k15_d4", True),
])
def test_a1b1_paired(tmp_path, case, canonical):
    cfg = Config(
        forward_files=(str(T / "a1.fastq"),), reverse_files=(str(T / "b1.fastq"),),
        ksize=15, depth=4, canonical=canonical, out_dir=str(tmp_path),
    )
    _, report = _run(cfg)
    want = _golden_stats(case)
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    for base in ("output_forward", "output_reverse"):
        _assert_same_file(
            tmp_path / f"{base}.k15_norm4_thread0.fastq",
            GOLDEN / case / f"{base}.k15_norm4_thread0.fastq",
        )


def test_multi_file_paired_fasta_out(tmp_path):
    cfg = Config(
        forward_files=(str(T / "a1.fastq"), str(T / "a2.fastq")),
        reverse_files=(str(T / "b1.fastq"), str(T / "b2.fastq")),
        ksize=15, depth=4, canonical=True, outformat="fa", out_dir=str(tmp_path),
    )
    _, report = _run(cfg)
    want = _golden_stats("multi_paired_fa_k15")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    for base in ("output_forward", "output_reverse"):
        _assert_same_file(
            tmp_path / f"{base}.k15_norm4_thread0.fastq",
            GOLDEN / "multi_paired_fa_k15" / f"{base}.k15_norm4_thread0.fastq",
        )


def test_a1_single_k13(tmp_path):
    cfg = Config(
        forward_files=(str(T / "a1.fastq"),), single=True, ksize=13, depth=4,
        out_dir=str(tmp_path), print_table=True,
    )
    _, report = _run(cfg)
    want = _golden_stats("a1_single_k13_d4")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    _assert_same_file(
        tmp_path / "output_forward.k13_norm4_thread0.fastq",
        GOLDEN / "a1_single_k13_d4" / "output_forward.k13_norm4_thread0.fastq",
    )
    _assert_same_file(
        tmp_path / "output_kmer.k13_norm4_thread0.tsv",
        GOLDEN / "a1_single_k13_d4" / "output_kmer.k13_norm4_thread0.tsv",
    )


def test_fasta_input_paired(tmp_path):
    """FASTA in / FASTA out paired-end (2-line records, reference -t fa)."""
    d = pathlib.Path(__file__).parent / "data"
    cfg = Config(
        forward_files=(str(d / "a1.fasta"),), reverse_files=(str(d / "b1.fasta"),),
        informat="fa", outformat="fa", ksize=15, depth=4, out_dir=str(tmp_path),
    )
    _, report = _run(cfg)
    want = _golden_stats("fasta_in_paired_k15")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    for base in ("output_forward", "output_reverse"):
        _assert_same_file(
            tmp_path / f"{base}.k15_norm4_thread0.fastq",
            GOLDEN / "fasta_in_paired_k15" / f"{base}.k15_norm4_thread0.fastq",
        )


def test_mixed_paired_and_single(tmp_path):
    """--single: fwd files without a matching rev file run single-end
    (reference main :2310-2392 dispatch)."""
    cfg = Config(
        forward_files=(str(T / "a1.fastq"), str(T / "a2.fastq")),
        reverse_files=(str(T / "b1.fastq"),),
        single=True, ksize=15, depth=4, out_dir=str(tmp_path),
    )
    _, report = _run(cfg)
    want = _golden_stats("mixed_single_k15")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    for base in ("output_forward", "output_reverse"):
        _assert_same_file(
            tmp_path / f"{base}.k15_norm4_thread0.fastq",
            GOLDEN / "mixed_single_k15" / f"{base}.k15_norm4_thread0.fastq",
        )


def test_dispatch_group_parity(tmp_path):
    """--dispatch-group G must be decision- and output-identical to G=1:
    step_many is the same sequential super-steps in one lax.scan dispatch.
    Small batches force several full groups plus a remainder flush."""
    cfg = Config(
        forward_files=(str(T / "a1.fastq"),), reverse_files=(str(T / "b1.fastq"),),
        ksize=15, depth=4, out_dir=str(tmp_path), batch_reads=512,
        dispatch_group=3,
    )
    _, report = _run(cfg)
    want = _golden_stats("a1b1_paired_k15_d4")
    assert (report.total_processed, report.total_printed, report.total_skipped,
            report.max_total_kmers) == want
    for base in ("output_forward", "output_reverse"):
        _assert_same_file(
            tmp_path / f"{base}.k15_norm4_thread0.fastq",
            GOLDEN / "a1b1_paired_k15_d4" / f"{base}.k15_norm4_thread0.fastq",
        )


def test_dispatch_group_multi_shard(tmp_path):
    """Grouped dispatch with 2 shards: per-shard queues must not interleave
    state (round-robin deal, independent tables)."""
    cfg1 = Config(
        forward_files=(str(T / "a1.fastq"),), reverse_files=(str(T / "b1.fastq"),),
        ksize=15, depth=4, shards=2, out_dir=str(tmp_path / "g1"),
        batch_reads=256, dispatch_group=1,
    )
    cfg3 = Config(
        forward_files=(str(T / "a1.fastq"),), reverse_files=(str(T / "b1.fastq"),),
        ksize=15, depth=4, shards=2, out_dir=str(tmp_path / "g3"),
        batch_reads=256, dispatch_group=3,
    )
    (tmp_path / "g1").mkdir()
    (tmp_path / "g3").mkdir()
    _, r1 = _run(cfg1)
    _, r3 = _run(cfg3)
    assert (r1.total_processed, r1.total_printed, r1.total_skipped) == (
        r3.total_processed, r3.total_printed, r3.total_skipped)
    for s in (0, 1):
        for base in ("output_forward", "output_reverse"):
            f1 = tmp_path / "g1" / f"{base}.k15_norm2_thread{s}.fastq"
            f3 = tmp_path / "g3" / f"{base}.k15_norm2_thread{s}.fastq"
            assert f1.read_bytes() == f3.read_bytes(), f"{base} shard {s}"
