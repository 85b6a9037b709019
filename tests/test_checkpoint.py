"""Checkpoint/resume: an interrupted run resumed from a snapshot must produce
byte-identical outputs and identical totals to an uninterrupted run."""
import pathlib

import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer

T = pathlib.Path(__file__).parent / "data"


def _cfg(tmp, **kw):
    base = dict(
        forward_files=(str(T / "a1.fastq"),),
        single=True,
        ksize=11,
        depth=4,
        batch_reads=512,
        out_dir=str(tmp),
        checkpoint_dir=str(tmp / "ckpt"),
    )
    base.update(kw)
    return Config(**base)


def test_resume_matches_uninterrupted(tmp_path):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir(), b.mkdir()

    # uninterrupted reference run
    rep_full = Normalizer(_cfg(a)).run()
    out_full = (a / "output_forward.k11_norm4_thread0.fastq").read_bytes()

    # interrupted run: process ~half with checkpoints every batch, then abort
    cfg_b = _cfg(b, checkpoint_every=1)
    n = Normalizer(cfg_b)

    stop_after = {"count": 0}
    orig = Normalizer._retire

    def bomb(self, *args):
        r = orig(self, *args)
        stop_after["count"] += 1
        if stop_after["count"] == 5:
            raise KeyboardInterrupt
        return r

    Normalizer._retire = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            n.run()
    finally:
        Normalizer._retire = orig

    # resume and finish
    rep = Normalizer(_cfg(b, checkpoint_every=1, resume=True)).run()
    out = (b / "output_forward.k11_norm4_thread0.fastq").read_bytes()

    assert (rep.total_processed, rep.total_printed, rep.total_skipped) == (
        rep_full.total_processed, rep_full.total_printed, rep_full.total_skipped
    )
    assert out == out_full


def test_resume_config_mismatch_rejected(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_every=1)
    Normalizer(cfg).run()
    bad = _cfg(tmp_path, checkpoint_every=1, resume=True, depth=8)
    with pytest.raises(ValueError, match="mismatch"):
        Normalizer(bad).run()


def test_seed_table_tsv(tmp_path):
    # run once with -P to get a kmer dump, then use it as a seed table
    cfg1 = _cfg(tmp_path / "x", print_table=True)
    (tmp_path / "x").mkdir()
    Normalizer(cfg1).run()
    dump = tmp_path / "x" / "output_kmer.k11_norm4_thread0.tsv"
    assert dump.exists()

    (tmp_path / "y").mkdir()
    cfg2 = _cfg(tmp_path / "y", seed_table=str(dump))
    n = Normalizer(cfg2)
    rep = n.run()
    assert rep.total_processed == 5000
    # every dumped kmer must be in the seeded set
    assert n.seeded_lo is not None and n.seeded_lo.size == len(
        dump.read_text().splitlines()
    )


def test_stride_mode_runs(tmp_path):
    rep1 = Normalizer(_cfg(tmp_path, stride=1)).run()
    for f in tmp_path.glob("output_forward*"):
        f.unlink()
    rep4 = Normalizer(_cfg(tmp_path, stride=4)).run()
    assert rep4.total_processed == rep1.total_processed == 5000
    # decisions are similar but not identical; both keep a sane majority
    assert 0.5 < rep4.total_printed / rep1.total_printed < 1.5


def test_resume_after_completed_run_reports_totals(tmp_path):
    """Resuming a run whose checkpoint says every file is done must re-report
    the restored totals, not zeros (regression: the per-file absorb never ran
    when all files were skipped)."""
    rep1 = Normalizer(_cfg(tmp_path, checkpoint_every=1)).run()
    rep2 = Normalizer(_cfg(tmp_path, checkpoint_every=1, resume=True)).run()
    assert (rep2.total_processed, rep2.total_printed, rep2.total_skipped,
            rep2.max_total_kmers) == (
        rep1.total_processed, rep1.total_printed, rep1.total_skipped,
        rep1.max_total_kmers)


def test_wide_table_checkpoint_roundtrip(tmp_path):
    """The hashed table's key planes must survive a save/load cycle and
    resume byte-identically at k=21."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    kw = dict(ksize=21, table="hashed", forward_files=(str(T / "2seq.fastq"),),
              depth=2, batch_reads=1)
    rep_full = Normalizer(_cfg(a, **kw)).run()
    out_full = (a / "output_forward.k21_norm2_thread0.fastq").read_bytes()

    cfg_b = _cfg(b, checkpoint_every=1, **kw)
    n = Normalizer(cfg_b)
    stop_after = {"count": 0}
    orig = Normalizer._retire

    def bomb(self, *args):
        r = orig(self, *args)
        stop_after["count"] += 1
        if stop_after["count"] == 2:
            raise KeyboardInterrupt
        return r

    Normalizer._retire = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            n.run()
    finally:
        Normalizer._retire = orig

    rep = Normalizer(_cfg(b, checkpoint_every=1, resume=True, **kw)).run()
    out = (b / "output_forward.k21_norm2_thread0.fastq").read_bytes()
    assert out == out_full
    assert (rep.total_processed, rep.total_printed) == (
        rep_full.total_processed, rep_full.total_printed)
