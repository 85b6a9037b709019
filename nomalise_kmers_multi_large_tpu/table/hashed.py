"""Hashed count table: device-resident open addressing with on-device insertion.

The device re-design of the reference's ``store_kmer``/``expand_local_hash_table``
(normalise_kmers_multi_large.c:929-1108) for k > 15, where a dense 4^k array no
longer fits. Intentional, documented divergences from the reference:

- A real mixing hash (murmur3 fmix32 over both code planes) instead of the identity
  ``code % capacity`` (:936) — the identity hash clusters biological k-mers badly.
- Power-of-two capacity with triangular probing (offsets r(r+1)/2, which visit every
  slot when the capacity is a power of two) instead of prime capacity with the
  reference's cumulative-quadratic probe.
- A CORRECT collision policy: the reference's collision branch corrupts counts along
  the probe chain and loses the inserted key (SURVEY.md section 2.2); we do classic
  upsert. Parity configs (k<=15) use the DirectTable, where the reference itself is
  collision-free, so this divergence never affects parity testing.

Insertion is batched and lock-free in the XLA dataflow sense: candidate slots are
claimed by scattering a unique per-code TICKET into the key hi-plane (a single
32-bit element-wise scatter — duplicate indices resolve to exactly one surviving
value), the survivors re-read their ticket to learn they won, and only winners
(now guaranteed unique slot indices) write their real key planes. This replaces the
CPU's compare-and-swap with plain XLA scatters: whichever duplicate write the
backend lets survive (last writer on the CPU, an arbitrary one under GPU
scatter), exactly one ticket lands per slot and its owner is the only winner.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nomalise_kmers_multi_large_tpu.ops.streamrank import SortedStream
from nomalise_kmers_multi_large_tpu.table.base import CountTable, TableState

_I32_MIN = np.int32(-(2**31))
#: Tickets live in 0xC0000000+ — real hi planes are < 2^30 (k <= 31 => 62-bit codes)
_TICKET_BASE = jnp.uint32(0xC0000000)
_MAX_PROBE = 64
_GROW_LOAD = 0.5


def _fmix32(x: jax.Array) -> jax.Array:
    """murmur3 finalizer; wraps in uint32 arithmetic."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


def _slot_hash(hi: jax.Array, lo: jax.Array) -> jax.Array:
    return _fmix32(lo ^ _fmix32(hi ^ jnp.uint32(0x9E3779B9)))


@partial(jax.jit, static_argnames=("capacity",), donate_argnums=(0,))
def _insert(keys: jax.Array, qhi: jax.Array, qlo: jax.Array, want: jax.Array,
            capacity: int):
    """Find-or-insert a stream of codes into `keys` ([2, C] hi/lo planes).

    Returns (keys, slot[int32, -1 = unresolved], n_new, n_overflow). `want` marks
    which stream positions carry a real (unique within stream) code.
    """
    n = qhi.shape[0]
    mask = jnp.uint32(capacity - 1)
    h = _slot_hash(qhi, qlo)
    pos = jnp.arange(n, dtype=jnp.uint32)
    ticket = _TICKET_BASE + pos

    def round_body(state):
        keys, slot, pending, new_cnt, r = state
        off = (r * (r + 1)) // jnp.uint32(2)
        cand = ((h + off) & mask).astype(jnp.int32)
        gcand = jnp.where(pending, cand, 0)
        ghi = keys[0, :][gcand]
        glo = keys[1, :][gcand]
        match = pending & (ghi == qhi) & (glo == qlo)
        empty = pending & (ghi == jnp.uint32(0)) & (glo == jnp.uint32(0))
        slot = jnp.where(match, cand, slot)
        pending = pending & ~match

        # claim phase: one element-wise ticket scatter, survivors win the slot
        claim_idx = jnp.where(empty, cand, _I32_MIN)
        khi = keys[0, :].at[claim_idx].set(ticket, mode="drop")
        won = empty & (khi[gcand] == ticket)
        win_idx = jnp.where(won, cand, _I32_MIN)
        khi = khi.at[win_idx].set(qhi, mode="drop", unique_indices=True)
        klo = keys[1, :].at[win_idx].set(qlo, mode="drop", unique_indices=True)
        # losers' tickets were overwritten by the winner's real key; slots that
        # received only tickets always have a winner, so no ticket survives a round
        keys = jnp.stack([khi, klo])
        slot = jnp.where(won, cand, slot)
        pending = pending & ~won
        new_cnt = new_cnt + jnp.sum(won).astype(jnp.int32)
        return keys, slot, pending, new_cnt, r + jnp.uint32(1)

    def cond(state):
        _, _, pending, _, r = state
        return jnp.any(pending) & (r < jnp.uint32(_MAX_PROBE))

    slot0 = jnp.full((n,), -1, jnp.int32)
    new0 = jnp.zeros((), jnp.int32)
    with jax.named_scope("probe"):
        keys, slot, pending, n_new, _ = jax.lax.while_loop(
            cond, round_body, (keys, slot0, want, new0, jnp.uint32(0))
        )
    return keys, slot, n_new, jnp.sum(pending).astype(jnp.int32)


class HashedTable(CountTable):
    def __init__(self, k: int, initial_capacity: int):
        assert initial_capacity & (initial_capacity - 1) == 0, "capacity must be 2^m"
        self.k = k
        self._capacity = initial_capacity

    @property
    def capacity(self) -> int:
        return self._capacity

    def init(self) -> TableState:
        return TableState(
            counts=jnp.zeros((self._capacity,), jnp.int32),
            keys=jnp.zeros((2, self._capacity), jnp.uint32),
            used=jnp.zeros((), jnp.int32),
            overflow=jnp.zeros((), jnp.int32),
        )

    def count_and_update(self, state, stream: SortedStream, seed: bool = False):
        keys, slot, n_new, n_over = _insert(
            state.keys, stream.hi, stream.lo, stream.boundary, self._capacity
        )
        used = state.used + n_new
        overflow = state.overflow + n_over

        if seed:
            # count-0 inserts: keys/used change, counts don't (reference do_init
            # path, store_kmer :962-963,:1001)
            return TableState(state.counts, keys, used, overflow), jnp.zeros_like(stream.rank)

        prior_head = state.counts.at[slot].get(mode="fill", fill_value=0)
        # broadcast the segment head's prior to every occurrence in the segment:
        # head position = pos - rank + 1 by construction of rank
        pos = jnp.arange(stream.rank.shape[0], dtype=jnp.int32)
        head_idx = pos - stream.rank + 1
        observed = prior_head[head_idx] + stream.rank

        counts = state.counts.at[slot].add(
            jnp.where(stream.boundary, stream.mult, 0), mode="drop", unique_indices=True
        )
        return TableState(counts, keys, used, overflow), observed

    # ------------------------------------------------------------------
    #: engine grows when projected occupancy exceeds this fraction (probe
    #: chains need low load; reference grows at 0.8, nk.c:143,933-934)
    grow_headroom = _GROW_LOAD

    @property
    def can_grow(self) -> bool:
        # slot indices are int32 on device; 2^30 slots = 12 GB of table state
        return self._capacity < (1 << 30)

    def grown(self, state: TableState):
        """Reallocate at 2x capacity and re-insert every occupied slot (the role of
        the reference's expand_local_hash_table :1055-1108, minus its linear-probe
        rehash bug). Unique existing keys re-insert conflict-free via the same
        ticket protocol."""
        new_cap = self._capacity * 2
        new = HashedTable(self.k, new_cap)
        occ_hi, occ_lo = state.keys[0, :], state.keys[1, :]
        occupied = (occ_hi | occ_lo) != jnp.uint32(0)
        nkeys = jnp.zeros((2, new_cap), jnp.uint32)
        nkeys, slot, n_new, n_over = _insert(nkeys, occ_hi, occ_lo, occupied, new_cap)
        ncounts = jnp.zeros((new_cap,), jnp.int32).at[slot].add(
            jnp.where(occupied, state.counts, 0), mode="drop", unique_indices=True
        )
        new_state = TableState(
            counts=ncounts, keys=nkeys, used=n_new, overflow=jnp.zeros((), jnp.int32)
        )
        return new, new_state

    def used_count(self, state: TableState, seeded_lo=None) -> int:
        return int(state.used)

    def export(self, state: TableState, seeded_lo: Optional[np.ndarray] = None):
        """(hi, lo, count) of occupied slots in ascending code order — the
        same -P normalization every table uses (docs/ARCHITECTURE.md), so
        dumps are table-implementation independent."""
        keys = np.asarray(state.keys)
        counts = np.asarray(state.counts)
        occ = np.nonzero((keys[0] | keys[1]) != 0)[0]
        hi, lo = keys[0, occ], keys[1, occ]
        code = (hi.astype(np.uint64) << np.uint64(32)) | lo
        order = np.argsort(code, kind="stable")
        return hi[order], lo[order], counts[occ][order].astype(np.int32)
