"""Sort-based exact occurrence ranking.

The central trick that makes batched diginorm match the reference's sequential
semantics. In the reference, read N's keep/skip decision depends on every k-mer
upsert that happened before it — including earlier k-mers of the same read
(``sequence_to_hash`` normalise_kmers_multi_large.c:1459-1499 increments the count
and then immediately tests ``count >= depth_per_cpu``). Batching breaks that
ordering, so we reconstruct it algebraically:

  For occurrence g of k-mer code c (in stream order), the count the reference would
  have observed at its check is

      table_count_before_batch[c] + rank(g)

  where rank(g) is the 1-based index of g among the occurrences of c within the
  batch, in stream order.

A single stable sort of the batch's occurrence stream by code delivers: the rank of
every occurrence (position minus segment head), the per-code multiplicity for one
aggregated table update (no duplicate-index scatters), and sorted unique table
indices (monotone HBM access for the scatter/gather — the memory-bound hot path).

Stream order must be the reference's: pair 0 fwd windows, pair 0 rev windows,
pair 1 fwd, ... (``process_sequence_pair`` :1551-1566 hashes fwd fully, then rev).
Callers achieve this by interleaving mate rows.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["SortedStream", "sorted_occurrence_stream"]

#: Sentinel hi-plane for invalid occurrences. Real codes have hi < 2^30 (k<=31 uses
#: at most 62 bits), so the sentinel sorts strictly after every valid code.
_SENTINEL_HI = jnp.uint32(0xFFFFFFFF)


class SortedStream(NamedTuple):
    """The batch occurrence stream, sorted by (code, stream position)."""

    hi: jax.Array        # uint32 [N] sorted code hi planes (sentinel = invalid)
    lo: jax.Array        # uint32 [N] sorted code lo planes
    src: jax.Array       # int32  [N] original stream position of each sorted slot
    valid: jax.Array     # bool   [N] not-a-sentinel
    boundary: jax.Array  # bool   [N] first occurrence of its code (segment head)
    rank: jax.Array      # int32  [N] 1-based rank within the code's segment
    mult: jax.Array      # int32  [N] at segment heads: total occurrences of the code
                         #            in the batch; elsewhere 0

    def unsort(self, values_sorted: jax.Array, fill) -> jax.Array:
        """Scatter per-sorted-slot values back to stream order."""
        out = jnp.full(values_sorted.shape, fill, values_sorted.dtype)
        return out.at[self.src].set(values_sorted, mode="drop", unique_indices=True)


def sorted_occurrence_stream(
    hi: jax.Array, lo: jax.Array, valid: jax.Array, hi_is_zero: bool = False
) -> SortedStream:
    """Sort the flat occurrence stream and derive segment structure.

    Args:
      hi, lo: uint32 [N] code planes in stream order.
      valid: bool [N]; invalid occurrences are pushed to the end and excluded.
      hi_is_zero: k <= 15 => the hi plane is structurally zero; sort 2 keys
        instead of 3 and flag invalids in lo.

    The sort is lexicographic ``jax.lax.sort`` — the trailing unique stream
    index makes it stable, which is what gives ranks their sequential meaning.
    """
    with jax.named_scope("sort"):
        shi, slo, src, svalid = _sort(hi, lo, valid, hi_is_zero)
    with jax.named_scope("segments"):
        return _segments(shi, slo, src, svalid)


def _sort(hi, lo, valid, hi_is_zero: bool):
    n = hi.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    if hi_is_zero:
        # lo < 2^30 for k<=15 (2-bit codes), and for k=16 the all-T code is
        # 0xFFFFFFFF == the sentinel only if the k-mer is TTTTTTTTTTTTTTTT;
        # keep the 3-key path for k==16 at the caller.
        klo = jnp.where(valid, lo, _SENTINEL_HI)
        slo, src = jax.lax.sort((klo, pos), num_keys=2)
        shi = jnp.zeros_like(slo)
        svalid = slo != _SENTINEL_HI
        shi = jnp.where(svalid, shi, _SENTINEL_HI)
    else:
        khi = jnp.where(valid, hi, _SENTINEL_HI)
        klo = jnp.where(valid, lo, _SENTINEL_HI)
        shi, slo, src = jax.lax.sort((khi, klo, pos), num_keys=3)
        svalid = shi != _SENTINEL_HI
    return shi, slo, src, svalid


def _segments(shi, slo, src, svalid) -> SortedStream:
    n = shi.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    first = jnp.zeros((n,), jnp.bool_).at[0].set(True)
    changed = jnp.concatenate(
        [first[:1], (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])]
    )
    boundary = changed & svalid

    # Segment head position, broadcast forward: cummax of boundary positions.
    head = jax.lax.cummax(jnp.where(changed, pos, jnp.int32(0)))
    rank = pos - head + 1

    # Per-segment multiplicity, deposited at the head slot only: the head of the
    # NEXT segment (or the array end) minus this head. next_head via reverse cummin.
    next_head = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(changed, pos, jnp.int32(n))))
    )
    # next_head[i] currently = head position of segment starting at or after i;
    # we want the next boundary strictly AFTER each head.
    after = jnp.concatenate([next_head[1:], jnp.full((1,), n, jnp.int32)])
    mult = jnp.where(boundary, after - head, jnp.int32(0))

    return SortedStream(
        hi=shi, lo=slo, src=src, valid=svalid, boundary=boundary, rank=rank, mult=mult
    )
