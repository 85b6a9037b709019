"""Automatic table growth, wired end-to-end (VERDICT round-1 item 2).

The reference grows its per-thread table at 0.8 load factor on every insert
(nk.c:933-934, expand_local_hash_table :1055-1108) and therefore never loses
an insert. These tests pin the device equivalents: the hashed table's
re-insertion growth, the engine call sites that trigger it BEFORE a batch can
saturate the table, the overflow grow-and-replay, and resume-after-growth.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_tpu.table.hashed import HashedTable, _slot_hash

RNG = np.random.default_rng(11)
K = 9


def _write_fastq(path: pathlib.Path, reads: list[str]):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _make_reads(n=2000, length=60):
    """Mostly-random reads (many distinct k-mers force growth) with a cloned
    minority so depth thresholds actually skip something."""
    base = ["".join(RNG.choice(list("ACGT"), size=length)) for _ in range(8)]
    reads = []
    for i in range(n):
        if i % 3 == 0:
            reads.append(base[RNG.integers(0, len(base))])
        else:
            reads.append("".join(RNG.choice(list("ACGT"), size=length)))
    return reads


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    p = tmp_path_factory.mktemp("growth") / "reads.fastq"
    _write_fastq(p, _make_reads())
    return p


def test_hashed_growth_end_to_end_matches_direct(fastq, tmp_path):
    cfg_h = Config(
        forward_files=(str(fastq),), single=True, ksize=K, depth=4,
        out_dir=str(tmp_path / "h"), table="hashed", batch_reads=256,
    )
    cfg_d = Config(
        forward_files=(str(fastq),), single=True, ksize=K, depth=4,
        out_dir=str(tmp_path / "d"), table="direct", batch_reads=256,
    )
    (tmp_path / "h").mkdir()
    (tmp_path / "d").mkdir()
    nh = Normalizer(cfg_h)
    nh.tables = [HashedTable(K, 4096)]
    nh.states = [nh.tables[0].init()]
    rh = nh.run()
    rd = Normalizer(cfg_d).run()
    assert nh.tables[0].capacity > 4096, "growth never triggered"
    assert int(nh.states[0].overflow) == 0
    assert (rh.total_processed, rh.total_printed, rh.total_skipped) == (
        rd.total_processed, rd.total_printed, rd.total_skipped)
    fh = tmp_path / "h" / f"output_forward.k{K}_norm4_thread0.fastq"
    fd = tmp_path / "d" / f"output_forward.k{K}_norm4_thread0.fastq"
    assert fh.read_bytes() == fd.read_bytes()


def test_resume_rebuilds_grown_table(tmp_path):
    """A checkpoint written after growth restores with matching descriptors."""
    cfg = Config(
        forward_files=("x.fastq",), single=True, ksize=K, depth=4,
        table="hashed", out_dir=str(tmp_path), memory_gb=0,
    )
    n = Normalizer(cfg)
    start = n.tables[0].capacity
    n.states = [HashedTable(K, 2 * start).init()]
    n._rebuild_tables_from_states()
    assert n.tables[0].capacity == 2 * start


def test_seed_pass_grows(tmp_path, fastq):
    """Seeding alone (count-0 inserts) must also trigger growth: the reference
    seed pass inserts through the same store_kmer growth path."""
    cfg = Config(
        forward_files=(str(fastq),), single=True, ksize=K, depth=4,
        out_dir=str(tmp_path), table="hashed", batch_reads=128,
        seed_records=2000,  # seed the whole file: ~90k distinct k-mers
    )
    n = Normalizer(cfg)
    n.tables = [HashedTable(K, 4096)]
    n.states = [n.tables[0].init()]
    n.seed()
    assert n.tables[0].capacity > 4096
    assert int(n.states[0].overflow) == 0


def test_mesh_mode_a_grows_mid_stream(fastq, tmp_path):
    """Mode A on the mesh grows ALL stacked shard tables together mid-stream
    and loses no insert — previously growth only worked before the states
    moved onto the mesh."""
    from nomalise_kmers_multi_large_tpu.parallel.engine import MeshNormalizer

    def run(sub, tiny):
        out = tmp_path / sub
        out.mkdir()
        cfg = Config(
            forward_files=(str(fastq),), single=True, ksize=K, depth=4,
            out_dir=str(out), table="hashed", batch_reads=256,
        )
        n = MeshNormalizer(cfg, n_devices=2)
        if tiny:
            n.tables = [HashedTable(K, 4096)] * len(n.tables)
            n.states = [n.tables[0].init()]
        rep = n.run()
        return n, rep, out

    nt, rt, out_t = run("tiny", tiny=True)
    nb, rb, out_b = run("big", tiny=False)
    assert nt.tables[0].capacity > 4096, "mid-stream mesh growth never fired"
    for s in range(2):
        assert int(nt.shard_state(s).overflow) == 0
    assert (rt.total_processed, rt.total_printed, rt.total_skipped) == (
        rb.total_processed, rb.total_printed, rb.total_skipped)
    # identical per-shard outputs: growth must be decision-transparent
    for s in range(2):
        f1 = out_t / f"output_forward.k{K}_norm2_thread{s}.fastq"
        f2 = out_b / f"output_forward.k{K}_norm2_thread{s}.fastq"
        assert f1.read_bytes() == f2.read_bytes()


# ----------------------------------------------------------------------
# Overflow grow-and-replay: codes whose probe chains run out BELOW the
# occupancy growth trigger must not be lost — the engine detects the
# overflow at retire, grows from the pre-dispatch state, and replays the
# group.
# ----------------------------------------------------------------------

def same_home_codes(k: int, capacity: int, n: int) -> np.ndarray:
    """n distinct k-mer codes that all hash to home slot 0 of a
    ``capacity``-slot hashed table: each probe round resolves one of them,
    so more than the probe limit (64) cannot all be placed."""
    codes = np.arange(1, 4 ** k, dtype=np.uint32)[:2_000_000]
    h = np.asarray(_slot_hash(jnp.zeros(codes.shape, jnp.uint32),
                              jnp.asarray(codes)))
    picked = codes[(h & np.uint32(capacity - 1)) == 0][:n]
    assert picked.shape[0] == n, "not enough same-home codes in range"
    return picked


def _same_home_reads(k: int, capacity: int, n: int) -> list[str]:
    from nomalise_kmers_multi_large_tpu.ops.codec import decode_codes

    picked = same_home_codes(k, capacity, n)
    return decode_codes(np.zeros_like(picked), picked, k)


def test_hashed_probe_overflow_grows_and_replays(tmp_path):
    """70 distinct k-mers on one home slot, one batch: 64 probe rounds place
    64, the dispatch drops 6, the retire detects the overflow, grows,
    replays — and every insert is present afterwards (reference growth
    precedes loss, nk.c:933-934)."""
    k = 11
    reads = _same_home_reads(k, capacity=1024, n=70)
    p = tmp_path / "same_home.fastq"
    _write_fastq(p, reads)
    cfg = Config(
        forward_files=(str(p),), single=True, ksize=k, depth=100,
        out_dir=str(tmp_path / "o"), table="hashed", batch_reads=128,
        seed_records=1,  # reads are exactly k long: the len>k seed rule
                         # skips them all (nk.c:1347), isolating the main pass
    )
    (tmp_path / "o").mkdir()
    n = Normalizer(cfg)
    n.tables = [HashedTable(k, 1024)]
    n.states = [n.tables[0].init()]
    rep = n.run()
    assert n.tables[0].capacity > 1024, "overflow never triggered a replay-grow"
    assert int(n.states[0].overflow) == 0, "replay left dropped inserts"
    assert rep.total_printed == 70
    _, lo, counts = n.tables[0].export(n.states[0])
    assert lo.shape[0] == 70 and (counts == 1).all(), \
        "replay failed to recover every dropped insert"


def test_hashed_probe_overflow_replay_with_inflight_group(tmp_path):
    """Same saturation split over three single-batch groups so a group is
    already in flight when the overflowing one retires: the engine must
    also re-dispatch the in-flight group from the replayed state."""
    k = 11
    reads = _same_home_reads(k, capacity=1024, n=105)
    p = tmp_path / "same_home3.fastq"
    _write_fastq(p, reads)
    cfg = Config(
        forward_files=(str(p),), single=True, ksize=k, depth=100,
        out_dir=str(tmp_path / "o"), table="hashed", batch_reads=35,
        seed_records=1,
    )
    (tmp_path / "o").mkdir()
    n = Normalizer(cfg)
    n.tables = [HashedTable(k, 1024)]
    n.states = [n.tables[0].init()]
    rep = n.run()
    assert n.tables[0].capacity > 1024
    assert int(n.states[0].overflow) == 0
    assert rep.total_printed == 105
    _, lo, counts = n.tables[0].export(n.states[0])
    assert lo.shape[0] == 105 and (counts == 1).all()
