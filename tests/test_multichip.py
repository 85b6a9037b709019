"""Multi-device modes on the 8-device virtual CPU mesh.

Mode A must equal running 8 independent shards (reference per-thread semantics);
Mode B must equal the single-device exact run (one global table)."""
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
from nomalise_kmers_multi_large_tpu.io.pack import LUT
from nomalise_kmers_multi_large_tpu.parallel.mesh import data_mesh
from nomalise_kmers_multi_large_tpu.parallel.modes import ModeAStep, ModeBStep
from nomalise_kmers_multi_large_tpu.table import DirectTable, HashedTable
from oracle import Oracle

RNG = np.random.default_rng(7)
K = 9
DEPTH = 16
COVERAGE = 0.6
S = 8


def _reads(n, length=40):
    base = ["".join(RNG.choice(list("ACGT"), size=length)) for _ in range(4)]
    return [base[RNG.integers(0, len(base))] for _ in range(n)]


def _pack(seqs, pad=64):
    arr = np.zeros((len(seqs), pad), np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = LUT[np.frombuffer(s.encode(), np.uint8)]
        lengths[i] = len(s)
    return arr, lengths


def _mk_step(table, depth, paired=False):
    return BatchStep(
        table, k=K, depth_per_shard=depth, coverage=COVERAGE,
        canonical=False, paired=paired, mode="exact",
    )


def test_mode_a_matches_independent_shards():
    assert jax.device_count() >= S
    mesh = data_mesh(S)
    table = DirectTable(K)
    mstep = ModeAStep(mesh, _mk_step(table, DEPTH // S))
    state = mstep.init_states()

    reads = _reads(256)
    bases, lengths = _pack(reads)
    keeps = []
    for i in range(0, 256, 64):  # batches of 64 rows = 8 per device
        state, keep, stats, _ = mstep(
            state, jnp.asarray(bases[i: i + 64]), jnp.asarray(lengths[i: i + 64]),
            jnp.ones(64, bool),
        )
        keeps.append(np.asarray(keep))
        assert int(stats.processed) == 64
    got = np.concatenate(keeps)

    # reference semantics: device d sees rows [d*8:(d+1)*8] of each batch with its
    # own table and depth//S threshold
    oracles = [Oracle(K, DEPTH // S, COVERAGE) for _ in range(S)]
    want = np.zeros(256, bool)
    for b in range(4):
        for d in range(S):
            for j in range(8):
                idx = b * 64 + d * 8 + j
                want[idx] = oracles[d].process_single(reads[idx])
    np.testing.assert_array_equal(got, want)


def test_mode_b_matches_single_device_exact():
    mesh = data_mesh(S)
    reads = _reads(128)
    bases, lengths = _pack(reads)

    # single-device exact reference run
    t1 = DirectTable(K)
    s1 = _mk_step(t1, DEPTH)
    st1 = t1.init()
    st1, keep1, _, _ = s1.step(
        st1, jnp.asarray(bases), jnp.asarray(lengths), jnp.ones(128, bool)
    )

    t2 = DirectTable(K)
    mstep = ModeBStep(mesh, _mk_step(t2, DEPTH))
    st2 = mstep.init_state()
    st2, keep2, _, _ = mstep(
        st2, jnp.asarray(bases), jnp.asarray(lengths), jnp.ones(128, bool)
    )
    np.testing.assert_array_equal(np.asarray(keep1), np.asarray(keep2))
    np.testing.assert_array_equal(np.asarray(st1.counts), np.asarray(st2.counts))


def test_mode_b_hashed_global_table():
    mesh = data_mesh(S)
    t = HashedTable(K, 1 << 12)
    mstep = ModeBStep(mesh, _mk_step(t, DEPTH))
    st = mstep.init_state()
    reads = _reads(128)
    bases, lengths = _pack(reads)
    st, keep, stats, _ = mstep(
        st, jnp.asarray(bases), jnp.asarray(lengths), jnp.ones(128, bool)
    )
    assert int(stats.processed) == 128
    assert int(st.overflow) == 0
    # same decisions as direct single-device
    t1 = DirectTable(K)
    st1 = t1.init()
    st1, keep1, _, _ = _mk_step(t1, DEPTH).step(
        st1, jnp.asarray(bases), jnp.asarray(lengths), jnp.ones(128, bool)
    )
    np.testing.assert_array_equal(np.asarray(keep), np.asarray(keep1))


@pytest.mark.parametrize("k,kind", [(K, "direct"), (21, "hashed")])
def test_mode_b_auto_table(tmp_path, k, kind):
    """--sharding global with --table auto shards the same table a single
    device would use: the dense direct table for k <= 15, hashed above."""
    from nomalise_kmers_multi_large_tpu.config import Config
    from nomalise_kmers_multi_large_tpu.parallel.engine import MeshNormalizer

    cfg = Config(
        forward_files=(str(pathlib.Path(__file__).parent / "data" / "2seq.fastq"),), single=True,
        ksize=k, depth=16, sharding="global", table="auto",
        out_dir=str(tmp_path),
    )
    m = MeshNormalizer(cfg, 8)
    assert m.cfg.table_kind == kind
    assert m.cfg.shards == 1


def test_mode_a_hashed_table():
    """The hashed table (its while_loop probe rounds inside shard_map)
    composes with Mode A: same decisions as independent per-shard
    oracles."""
    assert jax.device_count() >= S
    mesh = data_mesh(S)
    table = HashedTable(K, 1 << 12)
    mstep = ModeAStep(mesh, _mk_step(table, DEPTH // S))
    state = mstep.init_states()

    reads = _reads(128)
    bases, lengths = _pack(reads)
    keeps = []
    for i in range(0, 128, 64):
        state, keep, stats, _ = mstep(
            state, jnp.asarray(bases[i: i + 64]),
            jnp.asarray(lengths[i: i + 64]), jnp.ones(64, bool),
        )
        keeps.append(np.asarray(keep))
        assert int(stats.processed) == 64
    got = np.concatenate(keeps)

    oracles = [Oracle(K, DEPTH // S, COVERAGE) for _ in range(S)]
    want = np.zeros(128, bool)
    for b in range(2):
        for d in range(S):
            for j in range(8):
                idx = b * 64 + d * 8 + j
                want[idx] = oracles[d].process_single(reads[idx])
    np.testing.assert_array_equal(got, want)
