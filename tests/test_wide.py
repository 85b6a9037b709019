"""Wide k-mers (k = 16..31) on the hashed table, the k > 15 main path:
engine-level decisions and final table contents vs the sequential oracle.
The reference serves k 5..31 through one hot loop
(normalise_kmers_multi_large.c:724, 1459-1499); these tests pin the hashed
table's two-plane codes to the same semantics."""
import jax.numpy as jnp
import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
from nomalise_kmers_multi_large_tpu.table import HashedTable
from oracle import Oracle
from test_engine import _make_reads, _pack

DEPTH = 3
COVERAGE = 0.6


def _run_wide(table, reads, batch_size, k, paired=False, canonical=True,
              stride=1):
    step = BatchStep(table, k=k, depth_per_shard=DEPTH, coverage=COVERAGE,
                     canonical=canonical, paired=paired, stride=stride)
    state = table.init()
    decisions = []
    rpr = 2 if paired else 1
    nrec = len(reads) // rpr
    for lo_i in range(0, nrec, batch_size):
        recs = range(lo_i, min(lo_i + batch_size, nrec))
        rows = []
        for rec in recs:
            rows.extend(reads[rec * rpr: rec * rpr + rpr])
        bases, lengths = _pack(rows, 64, k)
        if paired:
            rec_valid = (lengths[0::2] > 0) & (lengths[1::2] > 0)
            lengths[0::2] = np.where(rec_valid, lengths[0::2], 0)
            lengths[1::2] = np.where(rec_valid, lengths[1::2], 0)
        else:
            rec_valid = lengths > 0
        state, keep, stats, _ = step.step(
            state, jnp.asarray(bases), jnp.asarray(lengths),
            jnp.asarray(rec_valid))
        keep = np.asarray(keep)
        for j, rec in enumerate(recs):
            decisions.append(bool(keep[j]) if rec_valid[j] else None)
    return decisions, state


def _table_dict(table, state):
    hi, lo, counts = table.export(state)
    return {(int(h) << 32) | int(l): int(c) for h, l, c in zip(hi, lo, counts)}


@pytest.mark.parametrize("k", [16, 21, 28, 31])
def test_wide_table_matches_oracle(k):
    """Decisions and table contents equal the sequential oracle across the
    whole wide range (k = 16 is the first two-plane width, 31 the last)."""
    reads = _make_reads(64)
    oracle = Oracle(k, DEPTH, COVERAGE, True)
    want = [oracle.process_single(r) for r in reads]
    table = HashedTable(k, 1 << 12)
    got, state = _run_wide(table, reads, 16, k)
    assert got == want
    assert int(state.overflow) == 0
    assert _table_dict(table, state) == oracle.counts
    assert table.used_count(state) == len(oracle.counts)


def test_wide_paired_k21_matches_oracle():
    reads = _make_reads(64)
    oracle = Oracle(21, DEPTH, COVERAGE, True)
    want = [oracle.process_pair(reads[i], reads[i + 1])
            for i in range(0, len(reads) - 1, 2)]
    table = HashedTable(21, 1 << 12)
    got, state = _run_wide(table, reads, 8, 21, paired=True)
    assert got == want
    assert _table_dict(table, state) == oracle.counts


@pytest.mark.parametrize("k,stride", [(13, 2), (17, 2), (25, 3)])
def test_wide_stride_matches_oracle(k, stride):
    """--stride s counts every s-th window of each read; decisions and the
    table must equal an oracle that samples the same windows."""
    reads = _make_reads(48)
    oracle = Oracle(k, DEPTH, COVERAGE, True, stride=stride)
    want = [oracle.process_single(r) for r in reads]
    table = HashedTable(k, 1 << 12)
    got, state = _run_wide(table, reads, 16, k, stride=stride)
    assert got == want
    assert _table_dict(table, state) == oracle.counts
