"""BatchStep vs the sequential oracle: decisions must match for any batch size
(exact mode), single and paired, with and without canonicalization."""
import numpy as np
import jax.numpy as jnp
import pytest

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
from nomalise_kmers_multi_large_tpu.io.pack import LUT
from nomalise_kmers_multi_large_tpu.table import DirectTable, HashedTable
from oracle import Oracle

RNG = np.random.default_rng(3)
K = 9
DEPTH = 3
COVERAGE = 0.6


def _mutate(seq, n):
    s = list(seq)
    for _ in range(n):
        s[RNG.integers(0, len(s))] = "ACGT"[RNG.integers(0, 4)]
    return "".join(s)


def _make_reads(n, length=40):
    """Read population with heavy duplication so depth thresholds trigger."""
    base = ["".join(RNG.choice(list("ACGT"), size=length)) for _ in range(max(2, n // 8))]
    reads = []
    for _ in range(n):
        b = base[RNG.integers(0, len(base))]
        reads.append(_mutate(b, RNG.integers(0, 3)))
    # sprinkle short/invalid reads and N runs
    reads[n // 3] = "ACGT"  # shorter than k -> invalid
    if n > 10:
        r = list(reads[n // 2])
        r[:6] = "NNNNNN"
        reads[n // 2] = "".join(r)
    return reads


def _pack(seqs, pad, k):
    arr = np.zeros((len(seqs), pad), np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = LUT[np.frombuffer(s.encode(), np.uint8)]
        lengths[i] = len(s) if len(s) >= k else 0
    return arr, lengths


def _run_batched(table, reads, batch_size, paired, canonical, mode="exact"):
    step = BatchStep(
        table,
        k=K,
        depth_per_shard=DEPTH,
        coverage=COVERAGE,
        canonical=canonical,
        paired=paired,
        mode=mode,
    )
    state = table.init()
    decisions = []
    rpr = 2 if paired else 1
    nrec = len(reads) // rpr
    for lo_i in range(0, nrec, batch_size):
        recs = range(lo_i, min(lo_i + batch_size, nrec))
        rows = []
        for rec in recs:
            rows.extend(reads[rec * rpr: rec * rpr + rpr])
        bases, lengths = _pack(rows, 64, K)
        if paired:
            fl, rl = lengths[0::2], lengths[1::2]
            rec_valid = (fl > 0) & (rl > 0)
            lengths[0::2] = np.where(rec_valid, fl, 0)
            lengths[1::2] = np.where(rec_valid, rl, 0)
        else:
            rec_valid = lengths > 0
        state, keep, stats, _ = step.step(
            state, jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(rec_valid)
        )
        keep = np.asarray(keep)
        for j, rec in enumerate(recs):
            decisions.append(bool(keep[j]) if rec_valid[j] else None)
    return decisions, state


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("batch_size", [1, 7, 64])
def test_exact_matches_oracle(paired, canonical, batch_size, kind="direct"):
    reads = _make_reads(128)
    oracle = Oracle(K, DEPTH, COVERAGE, canonical)
    want = []
    if paired:
        for i in range(0, len(reads) - 1, 2):
            want.append(oracle.process_pair(reads[i], reads[i + 1]))
    else:
        for r in reads:
            want.append(oracle.process_single(r))

    table = DirectTable(K) if kind == "direct" else HashedTable(K, 1 << 12)
    got, state = _run_batched(table, reads, batch_size, paired, canonical)
    assert got == want
    assert int(state.overflow) == 0

    # table contents must equal the oracle's
    hi, lo, counts = table.export(state)
    got_table = {int(l): int(c) for l, c in zip(lo, counts)}
    assert got_table == oracle.counts


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("batch_size", [1, 7, 64])
def test_exact_matches_oracle_hashed(paired, canonical, batch_size):
    """The same grid on the hashed table (the k > 15 main path)."""
    test_exact_matches_oracle(paired, canonical, batch_size, kind="hashed")


@pytest.mark.parametrize("batch_size", [1, 13, 64])
def test_hashed_table_same_decisions_as_direct(batch_size):
    reads = _make_reads(96)
    d_dec, _ = _run_batched(DirectTable(K), reads, batch_size, False, False)
    h_dec, hstate = _run_batched(HashedTable(K, 1 << 14), reads, batch_size, False, False)
    assert d_dec == h_dec
    assert int(hstate.overflow) == 0


def test_exact_mode_batch_size_invariance():
    """The defining property of exact mode: decisions identical for any batching."""
    reads = _make_reads(90)
    a, _ = _run_batched(DirectTable(K), reads, 1, False, False)
    b, _ = _run_batched(DirectTable(K), reads, 90, False, False)
    assert a == b


def test_relaxed_mode_runs_and_is_close():
    reads = _make_reads(120)
    exact, _ = _run_batched(DirectTable(K), reads, 30, False, False)
    relaxed, _ = _run_batched(DirectTable(K), reads, 30, False, False, mode="relaxed")
    assert len(exact) == len(relaxed)
    agree = sum(1 for a, b in zip(exact, relaxed) if a == b)
    assert agree >= len(exact) * 0.8
    # batch size 1 relaxed == exact (no cross-record relaxation possible)
    e1, _ = _run_batched(DirectTable(K), reads, 1, False, False)
    r1, _ = _run_batched(DirectTable(K), reads, 1, False, False, mode="relaxed")
    assert e1 == r1


def test_pair_rule_avg_pools_tallies():
    """--pair-rule avg: the reference's commented-out pooled-pair rule
    (nk.c:1638-1647) — classify on (hf+hr)/(tf+tr), not per-mate AND.
    A pair with one fully-redundant mate and one fresh mate separates the
    two rules: AND skips it (fwd ratio 1.0), avg keeps it (pooled ~0.5)."""
    from nomalise_kmers_multi_large_tpu.models.diginorm import (
        keep_mask_paired,
    )

    hf = jnp.array([10, 0, 10])
    tf = jnp.array([10, 10, 10])
    hr = jnp.array([0, 0, 10])
    tr = jnp.array([10, 10, 10])
    # and: keep iff both ratios < cov -> [False, True, False]
    np.testing.assert_array_equal(
        np.asarray(keep_mask_paired(hf, tf, hr, tr, 0.9, rule="and")),
        [False, True, False])
    # avg: pooled ratios 0.5, 0.0, 1.0 -> [True, True, False]
    np.testing.assert_array_equal(
        np.asarray(keep_mask_paired(hf, tf, hr, tr, 0.9, rule="avg")),
        [True, True, False])


def test_pair_rule_avg_end_to_end(tmp_path):
    """Engine-level --pair-rule avg: a final pair whose fwd mate is fully
    redundant but rev mate is fresh is SKIPPED by the default AND rule and
    PRINTED by avg (the rule the reference's comment calls 'skips fewer
    sequences', nk.c:1648)."""
    from nomalise_kmers_multi_large_tpu.config import Config
    from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer

    rng = np.random.default_rng(7)
    a = "".join(rng.choice(list("ACGT"), size=40))
    b = "".join(rng.choice(list("ACGT"), size=40))
    fwd_reads = [a, a, a, a]
    rev_reads = [a, a, a, b]

    def write(path, reads):
        with open(path, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    fq_f, fq_r = tmp_path / "f.fastq", tmp_path / "r.fastq"
    write(fq_f, fwd_reads)
    write(fq_r, rev_reads)

    def run(rule, sub):
        out = tmp_path / sub
        out.mkdir()
        cfg = Config(
            forward_files=(str(fq_f),), reverse_files=(str(fq_r),),
            ksize=K, depth=2, coverage=0.9, out_dir=str(out),
            pair_rule=rule, seed_records=1,
        )
        rep = Normalizer(cfg).run()
        outp = (out / "output_forward.k9_norm2_thread0.fastq").read_text()
        return rep, outp

    rep_and, out_and = run("and", "and")
    rep_avg, out_avg = run("avg", "avg")
    assert rep_and.total_processed == rep_avg.total_processed == 4
    # identical mates make even pair 1 differ: its rev mate re-sees every
    # fwd k-mer at count 2 = depth (ratio 1.0), so AND skips all 4 pairs;
    # avg pools pairs 1 and 4 down to ratio 0.5 and keeps them
    assert rep_and.total_printed == 0
    assert rep_avg.total_printed == 2
    assert "@r3" not in out_and
    assert "@r0" in out_avg and "@r3" in out_avg


@pytest.mark.parametrize("coverage", [0.9, 0.5, 1.0, 1 / 3, 0.001])
def test_keep_rule_is_f32_ratio(coverage):
    """The device keep rule is a host-built integer table; it must decide
    exactly like f32(high) / f32(total) < f32(coverage) with IEEE rounding,
    including ratios that land on the coverage (9/10 at -g 0.9 is skipped)."""
    from nomalise_kmers_multi_large_tpu.models.diginorm import (
        keep_mask_single,
    )

    total = np.repeat(np.arange(0, 301), np.arange(1, 302)).astype(np.int32)
    high = np.concatenate([np.arange(t + 1) for t in range(301)]
                          ).astype(np.int32)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(total > 0, high.astype(np.float32)
                         / total.astype(np.float32), np.float32(0))
    want = ratio < np.float32(coverage)
    got = np.asarray(keep_mask_single(jnp.asarray(high), jnp.asarray(total),
                                      coverage, 300))
    np.testing.assert_array_equal(got, want)
    if coverage == 0.9:
        assert not got[(total == 10) & (high == 9)].any()
        assert got[(total == 10) & (high == 8)].all()
