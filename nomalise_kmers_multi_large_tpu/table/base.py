"""Count-table interface.

The device-resident replacement for the reference's per-thread open-addressing
table (``hash_table_t`` normalise_kmers_multi_large.c:163-168, ``store_kmer``
:929-1053). The interface is functional: a `TableState` pytree goes in, an updated
one comes out, so the whole batch step jits and shards cleanly.

Both implementations consume the SORTED occurrence stream from
`ops.streamrank.sorted_occurrence_stream` and return, per sorted occurrence, the
count the reference's sequential loop would have observed at that occurrence's
upsert (prior + rank). The collision-corruption quirk of the reference's probe
chain (SURVEY.md section 2.2) is deliberately NOT reproduced: in the collision-free
regime (table sized to 4^k) the reference degenerates to exact direct-address
counting, which the direct table matches bit-for-bit; the hashed table implements a
CORRECT open-addressing policy and is documented as an intentional divergence.
"""
from __future__ import annotations

import abc
from typing import NamedTuple, Optional

import jax
import numpy as np

from nomalise_kmers_multi_large_tpu.ops.streamrank import SortedStream


class TableState(NamedTuple):
    """Device arrays of one table shard. `keys` is None for the direct table."""

    counts: jax.Array               # int32 [C]
    keys: Optional[jax.Array]       # uint32 [C, 2] (hi, lo) or None
    used: jax.Array                 # int32 [] occupied slots (reference ht->used)
    overflow: jax.Array             # int32 [] codes dropped for want of a free slot
                                    # (hashed only; triggers growth)


class CountTable(abc.ABC):
    """Static (non-pytree) table descriptor; all state lives in TableState."""

    @abc.abstractmethod
    def init(self) -> TableState:
        """Fresh zeroed state (reference init_hash_table :890-906)."""

    @abc.abstractmethod
    def count_and_update(
        self, state: TableState, stream: SortedStream, seed: bool = False
    ) -> tuple[TableState, jax.Array]:
        """Apply one batch of upserts; return observed counts per sorted occurrence.

        observed[i] = count the reference would have seen when upserting sorted
        occurrence i (i.e. after its own increment). When ``seed`` is True, inserts
        use count 0 and existing counts are untouched (reference do_init=true path,
        store_kmer :962-963, :1001), and the returned counts are meaningless.
        """

    @abc.abstractmethod
    def export(self, state: TableState) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host copy: (hi, lo, count) arrays of occupied slots, in slot order
        (the reference -P dump order, print_kmer_table :354-385)."""

    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        ...

    def grown(self, state: TableState) -> tuple["CountTable", TableState]:
        raise NotImplementedError
