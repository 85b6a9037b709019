"""chip_smoke.py's CPU-checkable parts: the seeded input generator, the
FASTQ it writes, the prefix-vs-oracle comparison, the keep-rule sweep, and
its refusal to run without a GPU."""
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def _all(seed, n_pairs=500, n_tx=20, chunk=200):
    parts = list(cs.make_reads(seed, n_pairs, n_tx, chunk=chunk))
    return (np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))


def test_generator_deterministic_and_shaped():
    a1, a2 = _all(3)
    b1, b2 = _all(3)
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)
    c1, _ = _all(4)
    assert not np.array_equal(a1, c1)
    assert a1.shape == a2.shape == (500, cs.READ_LEN)
    assert a1.max() <= 4 and a1.dtype == np.uint8


def test_generator_error_and_n_rates():
    """About 0.1 % N per base, and reads of one transcript overlap: a pair
    drawn from a 5-transcript pool shares most 15-mers with the rest."""
    r1, r2 = _all(0, n_pairs=4000, n_tx=50, chunk=4000)
    n_rate = (np.concatenate([r1, r2]) == 4).mean()
    assert 0.0005 < n_rate < 0.002
    few, _ = _all(0, n_pairs=200, n_tx=5, chunk=200)
    kmers = {few[i, j:j + 15].tobytes() for i in range(1, 200)
             for j in range(136)}
    first = [few[0, j:j + 15].tobytes() for j in range(0, 136, 5)]
    assert sum(km in kmers for km in first) > len(first) // 2


def test_fastq_block_round_trips(tmp_path):
    _, r1, _ = next(cs.make_reads(1, 30, 5))
    blob = cs._fastq_block(1_234_560, r1, 2)
    lines = blob.decode().splitlines()
    assert len(lines) == 4 * 30
    assert lines[0] == "@p1234560/2" and lines[4] == "@p1234561/2"
    assert lines[1] == cs.BASES[r1[0]].tobytes().decode()
    assert lines[2] == "+" and lines[3] == "I" * cs.READ_LEN
    p = tmp_path / "x.fastq"
    p.write_bytes(blob)
    assert cs.printed_ids(str(p)) == set(range(1_234_560, 1_234_590))


def test_prefix_check_against_oracle_tiny(tmp_path):
    """Phase A's comparison at toy size on the CPU: the engine's printed
    set over the prefix equals the oracle's; a corrupted output fails."""
    sz = dict(cs.TINY, pairs=400, transcripts=5, prefix_a=400, prefix_c=50,
              prefix_four=50, batch_pairs=64)
    f1, f2, prefix = cs.write_inputs(0, sz, str(tmp_path / "data"))
    out = tmp_path / "A"
    clock = cs.CompileClock()
    norm, fields = cs.run_cli(cs.base_argv(
        f1, f2, str(out), sz, "-k", "11", "-d", "8", "--devices", "1"), clock)
    assert fields["processed"] == 400
    assert fields["skipped"] > 0  # the prefix check must see both decisions
    got = cs.prefix_check(str(out), 11, 8, prefix, False)
    assert got["prefix_pairs"] == 400 and 0 < got["prefix_kept"] < 400

    path = out / "output_forward.k11_norm8_thread0.fastq"
    lines = path.read_bytes().splitlines(keepends=True)
    path.write_bytes(b"".join(lines[4:]))  # drop the first printed record
    with pytest.raises(cs.CheckFailed):
        cs.prefix_check(str(out), 11, 8, prefix, False)


def test_keep_rule_sweep_runs():
    res = cs.phase_keep_rule()
    assert res["cases_per_coverage"] == sum(t + 1 for t in range(1, 1024))
    assert res["boundary_cases_g0.5"] == 511


def test_refuses_to_run_without_gpu(capsys):
    assert cs.main(["--tiny"]) == 2
    assert "needs a GPU" in capsys.readouterr().err
