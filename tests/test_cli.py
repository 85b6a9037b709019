"""CLI surface: flag parsing, validation error texts, version, end-to-end main()."""
import pathlib

import pytest

from nomalise_kmers_multi_large_tpu import VERSION
from nomalise_kmers_multi_large_tpu.cli import config_from_args, main
from nomalise_kmers_multi_large_tpu.config import ConfigError
from nomalise_kmers_multi_large_tpu.parallel.multihost import assign_files

T = pathlib.Path(__file__).parent / "data"


def test_multi_value_file_flags():
    cfg = config_from_args([
        "-f", str(T / "a1.fastq"), str(T / "2seq.fastq"),
        "-r", str(T / "b1.fastq"), str(T / "2seq.fastq"),
        "-k", "13", "-d", "8", "-p", "2", "-c",
    ])
    assert len(cfg.forward_files) == 2 and len(cfg.reverse_files) == 2
    assert cfg.ksize == 13 and cfg.depth == 8 and cfg.shards == 2
    assert cfg.depth_per_shard == 4  # integer division (reference :674)
    assert cfg.canonical


def test_unreadable_files_skipped(capsys):
    cfg = config_from_args([
        "-f", str(T / "a1.fastq"), "/nonexistent/x.fastq", "--single",
    ])
    assert len(cfg.forward_files) == 1
    assert "skipping" in capsys.readouterr().err


@pytest.mark.parametrize("argv,match", [
    (["-f", str(T / "a1.fastq")], "reverse"),                      # no -r, no -s
    (["-f", str(T / "a1.fastq"), "--single", "-k", "99"], "kmer sizes"),
    (["-f", str(T / "a1.fastq"), "--single", "-d", "1"], "Depth"),
    (["-f", str(T / "a1.fastq"), "--single", "-g", "7"], "Coverage"),
    (["-f", str(T / "a1.fastq"), "--single", "-d", "4", "-p", "4"], "at least 2 x"),
    (["-f", str(T / "a1.fastq"), "--single", "-t", "fa", "-o", "fq"], "FASTQ when input is FASTA"),
    (["-f", str(T / "a1.fastq"), "--single", "-k", "21", "--table", "direct"],
     "direct table supports k<=15"),
    (["-f", str(T / "a1.fastq"), "--single", "--batch-reads", "0"],
     "batch-reads"),
], ids=["no-rev", "bad-k", "bad-depth", "bad-cov", "depth-per-cpu", "fa-to-fq",
        "direct-wide-k", "batch-zero"])
def test_validation_errors(argv, match):
    with pytest.raises(ConfigError, match=match):
        config_from_args(argv)


def test_version(capsys):
    with pytest.raises(SystemExit):
        config_from_args(["--version"])
    assert str(VERSION) in capsys.readouterr().out


def test_main_end_to_end(tmp_path, capsys):
    rc = main([
        "-f", str(T / "2seq.fastq"), "--single", "-k", "11", "-d", "2",
        "--out-dir", str(tmp_path), "--devices", "1", "--spectrum",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Final Report" in out and "Kmer Spectrum" in out
    assert (tmp_path / "output_forward.k11_norm2_thread0.fastq").exists()


def test_assign_files_round_robin():
    f = ("a", "b", "c", "d", "e")
    r = ("A", "B", "C")
    f0, r0 = assign_files(f, r, 0, 2)
    f1, r1 = assign_files(f, r, 1, 2)
    assert f0 == ("a", "c", "e") and r0 == ("A", "C")
    assert f1 == ("b", "d") and r1 == ("B",)
    assert set(f0) | set(f1) == set(f)


@pytest.mark.parametrize("table", ["bucket", "mxu", ""])
def test_table_choice_rejected_by_argparse(table, capsys):
    """--table offers exactly auto|direct|hashed; anything else is a usage
    error before any device work."""
    with pytest.raises(SystemExit) as e:
        config_from_args(["-f", str(T / "a1.fastq"), "--single",
                          "--table", table])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_k25_runs_hashed_table(tmp_path, capsys):
    """k > 15 resolves 'auto' to the hashed table and runs end to end."""
    rc = main([
        "-f", str(T / "2seq.fastq"), "--single", "-k", "25", "-d", "2",
        "--out-dir", str(tmp_path), "--devices", "1",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("hashed count table:")
    assert "Processed Records: 4" in out
