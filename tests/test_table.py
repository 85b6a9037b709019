"""Count tables: direct vs hashed equivalence, observed counts vs brute force,
seeding, growth, export."""
import numpy as np
import jax.numpy as jnp
import pytest

from nomalise_kmers_multi_large_tpu.ops.streamrank import sorted_occurrence_stream
from nomalise_kmers_multi_large_tpu.table import DirectTable, HashedTable

RNG = np.random.default_rng(2)


def _stream(codes, valid):
    hi = (codes >> 32).astype(np.uint32)
    lo = (codes & 0xFFFFFFFF).astype(np.uint32)
    return sorted_occurrence_stream(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))


def _observed_brute(all_batches):
    table = {}
    out = []
    for codes, valid in all_batches:
        obs = np.zeros(len(codes), np.int64)
        for i, (c, v) in enumerate(zip(codes, valid)):
            if not v:
                continue
            table[c] = table.get(c, 0) + 1
            obs[i] = table[c]
        out.append(obs)
    return out, table


@pytest.mark.parametrize("kind", ["direct", "hashed"])
def test_observed_counts_match_sequential(kind):
    k = 7
    table = DirectTable(k) if kind == "direct" else HashedTable(k, 1 << 12)
    state = table.init()
    batches = []
    for _ in range(3):
        codes = RNG.integers(0, 200, size=300).astype(np.uint64)
        valid = (RNG.random(300) > 0.1) & (codes != 0)
        batches.append((codes, valid))
    want_obs, want_table = _observed_brute(batches)

    for (codes, valid), want in zip(batches, want_obs):
        s = _stream(codes, valid)
        state, obs = table.count_and_update(state, s)
        got = np.zeros(len(codes), np.int64)
        src = np.asarray(s.src)
        sv = np.asarray(s.valid)
        got[src[sv]] = np.asarray(obs)[sv]
        np.testing.assert_array_equal(got, want)

    hi, lo, counts = table.export(state)
    got_table = {
        (int(h) << 32) | int(l): int(c) for h, l, c in zip(hi, lo, counts)
    }
    assert got_table == {int(c): n for c, n in want_table.items()}
    assert table.used_count(state) == len(want_table)


def test_hashed_seeding_inserts_count_zero():
    table = HashedTable(9, 1 << 10)
    state = table.init()
    codes = np.arange(1, 101, dtype=np.uint64)
    s = _stream(codes, np.ones(100, bool))
    state, _ = table.count_and_update(state, s, seed=True)
    assert table.used_count(state) == 100
    hi, lo, counts = table.export(state)
    assert len(counts) == 100 and (counts == 0).all()
    # normal pass over half of them increments from 0
    s2 = _stream(codes[:50], np.ones(50, bool))
    state, obs = table.count_and_update(state, s2)
    assert table.used_count(state) == 100
    hi, lo, counts = table.export(state)
    got = {int(l): int(c) for l, c in zip(lo, counts)}
    for c in range(1, 51):
        assert got[c] == 1
    for c in range(51, 101):
        assert got[c] == 0


def test_direct_seed_tracking_host_side():
    table = DirectTable(7)
    state = table.init()
    seeded = np.array([5, 6, 7], np.uint32)
    codes = np.array([5, 9], np.uint64)
    s = _stream(codes, np.ones(2, bool))
    state, _ = table.count_and_update(state, s)
    # 5 and 9 counted; 6,7 seeded-but-unseen still occupy slots
    assert table.used_count(state, seeded) == 4
    hi, lo, counts = table.export(state, seeded)
    got = {int(l): int(c) for l, c in zip(lo, counts)}
    assert got == {5: 1, 6: 0, 7: 0, 9: 1}


def test_hashed_growth_preserves_contents():
    table = HashedTable(9, 1 << 8)
    state = table.init()
    codes = RNG.choice(np.arange(1, 4**9, dtype=np.uint64), size=200, replace=False)
    s = _stream(codes, np.ones(200, bool))
    state, _ = table.count_and_update(state, s)
    assert int(state.used) > 0.5 * 256  # past the load the engine grows at
    table2, state2 = table.grown(state)
    assert table2.capacity == 512
    h1, l1, c1 = table.export(state)
    h2, l2, c2 = table2.export(state2)
    d1 = {(int(h) << 32) | int(l): int(c) for h, l, c in zip(h1, l1, c1)}
    d2 = {(int(h) << 32) | int(l): int(c) for h, l, c in zip(h2, l2, c2)}
    assert d1 == d2
    assert int(state2.used) == 200


def test_hashed_high_load_insert_all_resolve():
    """Fill a tiny table near capacity; the ticket protocol must place every
    distinct key without loss (while_loop probing)."""
    table = HashedTable(9, 256)
    state = table.init()
    codes = np.arange(1, 181, dtype=np.uint64)  # load 0.7
    s = _stream(codes, np.ones(180, bool))
    state, _ = table.count_and_update(state, s)
    assert int(state.overflow) == 0
    assert table.used_count(state) == 180
    _, lo, counts = table.export(state)
    assert sorted(lo.tolist()) == list(range(1, 181))
    assert (counts == 1).all()


@pytest.mark.parametrize("n", [40, 64, 70])
def test_ticket_protocol_same_home_slot(n):
    """Many distinct codes forced onto ONE home slot: every probe round's
    claim scatter sees all pending codes write the same slot, and exactly
    one ticket may survive it, whichever duplicate write the backend keeps.
    So round r places exactly one code: n <= 64 (the probe limit) all
    resolve to distinct slots; beyond it the rest are counted as overflow,
    never silently merged."""
    from test_growth import same_home_codes

    cap = 1024
    table = HashedTable(11, cap)
    state = table.init()
    codes = same_home_codes(11, cap, n).astype(np.uint64)
    s = _stream(codes, np.ones(n, bool))
    state, _ = table.count_and_update(state, s)
    placed = min(n, 64)
    assert int(state.used) == placed
    assert int(state.overflow) == n - placed
    _, lo, counts = table.export(state)
    assert lo.shape[0] == placed and (counts == 1).all()
    assert set(lo.tolist()) <= set(codes.tolist())
