"""The jitted per-batch device step: encode -> rank -> count -> classify.

This one compiled function is the device replacement for the reference's whole
per-thread hot loop (``process_thread_chunk_paired``
normalise_kmers_multi_large.c:1568-1770 and ``sequence_to_hash`` :1459-1499): where
the reference walks one k-mer at a time through a CPU hash table, this processes
every k-mer of every read in the batch as one dataflow graph:

  bases[R, L] --encode--> codes[R, W] --flatten+sort--> ranked stream
       --table upsert (aggregated)--> observed counts --unsort+reduce--> keep[B]

Exactness: with ``mode='exact'`` the sort-based ranks reproduce the reference's
sequential upsert-then-test semantics for ANY batch size (see ops/streamrank.py).
``mode='relaxed'`` trades strict stream-order rank attribution for speed — the
same kind of license the reference itself takes across threads (README.md:68),
but far tighter: ranks stay sequential only within a read pair, and the
direct table skips the global sort entirely.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nomalise_kmers_multi_large_tpu.models.diginorm import (
    keep_mask_paired,
    keep_mask_single,
)
from nomalise_kmers_multi_large_tpu.ops.codec import (
    encode_windows_canonical,
    window_validity,
)
from nomalise_kmers_multi_large_tpu.ops.streamrank import (
    SortedStream,
    sorted_occurrence_stream,
)
from nomalise_kmers_multi_large_tpu.table.base import CountTable, TableState


class StepStats(NamedTuple):
    processed: jax.Array  # int32 [] valid records/pairs in this batch
    printed: jax.Array    # int32 []
    skipped: jax.Array    # int32 []


class ReadTallies(NamedTuple):
    """Per-read high/total window counts (the reference's debug>1 report fields,
    nk.c:1677-1696)."""

    high: jax.Array   # int32 [R]
    total: jax.Array  # int32 [R]


class BatchStep:
    """Factory for the jitted batch functions of one table shard.

    Static configuration is bound at construction so the jitted callables close
    over Python ints/bools (k, coverage, ...) and stay retrace-free.
    """

    def __init__(
        self,
        table: CountTable,
        *,
        k: int,
        depth_per_shard: int,
        coverage: float,
        canonical: bool,
        paired: bool,
        mode: str = "exact",
        pair_rule: str = "and",
        stride: int = 1,
    ):
        self.table = table
        self.k = k
        self.depth = depth_per_shard
        self.coverage = coverage
        self.canonical = canonical
        self.paired = paired
        self.mode = mode
        self.pair_rule = pair_rule
        #: window stride: 1 = every window (reference semantics). s>1 samples
        #: every s-th window — the reference's own proposed optimization
        #: ("we could also do non-overlapping kmers", nk.c:30-33) — dividing all
        #: per-window costs by s. Opt-in; changes decisions slightly.
        self.stride = stride
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._step_many = jax.jit(self._step_many_impl, donate_argnums=(0,))
        self._seed = jax.jit(self._seed_impl, donate_argnums=(0,))

    # ------------------------------------------------------------------
    def _encode(self, bases, lengths):
        hi, lo = encode_windows_canonical(bases, self.k, self.canonical)
        valid = window_validity(lengths, hi, lo, self.k)
        if self.stride > 1:
            hi = hi[:, :: self.stride]
            lo = lo[:, :: self.stride]
            valid = valid[:, :: self.stride]
        return hi, lo, valid

    def _relaxed_ranks(self, hi, lo, valid, reads_per_record: int):
        """Pair-local ranks without a global sort.

        rank of window i within its record = # windows j <= i (over BOTH mates,
        fwd windows first) with the same code. O(W'^2) elementwise compares per
        record. Matches the reference exactly for
        duplicates within one record; cross-record duplicates in the same batch
        are relaxed (they all observe the pre-batch table count + own-record rank).
        """
        R, W = hi.shape
        rec = R // reads_per_record
        h = hi.reshape(rec, reads_per_record * W)
        l = lo.reshape(rec, reads_per_record * W)
        v = valid.reshape(rec, reads_per_record * W)
        eq = (h[:, :, None] == h[:, None, :]) & (l[:, :, None] == l[:, None, :])
        eq = eq & v[:, None, :]
        tri = jnp.tril(jnp.ones((reads_per_record * W, reads_per_record * W), jnp.bool_))
        rank = jnp.sum(eq & tri[None], axis=2).astype(jnp.int32)
        return rank.reshape(R, W)

    # ------------------------------------------------------------------
    def _step_impl(self, state: TableState, bases, lengths, rec_valid):
        """One normalization super-step.

        Args:
          state: table shard state (donated).
          bases: uint8 [R, L] 2-bit base codes; rows in reference stream order
            (paired: fwd0, rev0, fwd1, rev1, ...).
          lengths: int32 [R]; 0 marks an invalid mate/read (host sets both mates of
            an invalid pair to 0: the reference drops such records without
            counting them at all, :1629-1631).
          rec_valid: bool [B] record validity.

        Returns: (state', keep[B] bool, StepStats)
        """
        R = bases.shape[0]

        from nomalise_kmers_multi_large_tpu.table.direct import DirectTable

        with jax.named_scope("encode"):
            hi, lo, valid = self._encode(bases, lengths)
        W = hi.shape[1]
        n = R * W

        if self.mode == "relaxed" and isinstance(self.table, DirectTable):
            # sort-free fast path: stream-order prior gather + duplicate
            # scatter-add; within-record sequentiality via pair-local ranks
            with jax.named_scope("table"):
                state, prior = self.table.relaxed_update(
                    state, lo.reshape(n), valid.reshape(n)
                )
            with jax.named_scope("relaxed_ranks"):
                local_rank = self._relaxed_ranks(
                    hi, lo, valid, 2 if self.paired else 1)
            observed = prior.reshape(R, W) + local_rank
            high = (observed >= self.depth) & valid
        else:
            stream = sorted_occurrence_stream(
                hi.reshape(n), lo.reshape(n), valid.reshape(n),
                hi_is_zero=self.k <= 15,
            )
            with jax.named_scope("table"):
                state, observed = self.table.count_and_update(state, stream)
            if self.mode == "relaxed":
                # pair-local sequential semantics: each occurrence observes the
                # PRE-batch count (observed - global rank recovers it at segment
                # granularity) plus its rank within its own record only
                with jax.named_scope("relaxed_ranks"):
                    pre_batch = observed - stream.rank
                    local_rank = self._relaxed_ranks(
                        hi, lo, valid, 2 if self.paired else 1
                    )
                    local_sorted = local_rank.reshape(n)[stream.src]
                    observed = pre_batch + local_sorted
            with jax.named_scope("unsort"):
                high_sorted = (observed >= self.depth) & stream.valid
                high = stream.unsort(high_sorted.astype(jnp.int8), jnp.int8(0))
                high = high.reshape(R, W).astype(jnp.bool_)

        with jax.named_scope("classify"):
            total_per_read = jnp.sum(valid, axis=1).astype(jnp.int32)
            high_per_read = jnp.sum(high & valid, axis=1).astype(jnp.int32)
            return self._classify(
                state, high_per_read, total_per_read, rec_valid, W)

    def _classify(self, state, high_per_read, total_per_read, rec_valid,
                  windows: int):
        """Keep/skip decision + batch stats from per-read window tallies
        (each read's total is at most its row's window count)."""
        if self.paired:
            keep = keep_mask_paired(
                high_per_read[0::2], total_per_read[0::2],
                high_per_read[1::2], total_per_read[1::2],
                self.coverage, self.pair_rule, windows,
            )
        else:
            keep = keep_mask_single(high_per_read, total_per_read,
                                    self.coverage, windows)

        keep = keep & rec_valid
        nvalid = jnp.sum(rec_valid).astype(jnp.int32)
        nprint = jnp.sum(keep).astype(jnp.int32)
        stats = StepStats(processed=nvalid, printed=nprint, skipped=nvalid - nprint)
        tallies = ReadTallies(high=high_per_read, total=total_per_read)
        return state, keep, stats, tallies

    # ------------------------------------------------------------------
    def _seed_impl(self, state: TableState, bases, lengths):
        """Seeding pass: insert k-mers with count 0 (reference seed_kmer_hash
        :1322-1373). The host pre-filters records to the reference's strictly-
        greater length rule (len > k, :1347) by zeroing their lengths."""
        R = bases.shape[0]

        hi, lo, valid = self._encode(bases, lengths)
        n = R * hi.shape[1]

        stream = sorted_occurrence_stream(
            hi.reshape(n), lo.reshape(n), valid.reshape(n),
            hi_is_zero=self.k <= 15,
        )
        state, _ = self.table.count_and_update(state, stream, seed=True)
        return state

    def _step_many_impl(self, state: TableState, bases, lengths, rec_valid):
        """G sequential super-steps in ONE device dispatch (lax.scan).

        Grouping G staged batches pays the per-dispatch host/runtime cost
        once per group. Semantics are identical to G ``step`` calls: the
        scan carries the table state, so batch i+1 sees batch i's counts
        exactly as the streaming loop would.

        Args: leading axis G on every operand. Returns stacked
        (keep[G, B], StepStats[G], ReadTallies[G]).
        """

        def body(st, xs):
            b, ln, rv = xs
            st, keep, stats, tallies = self._step_impl(st, b, ln, rv)
            return st, (keep, stats, tallies)

        state, (keep, stats, tallies) = jax.lax.scan(
            body, state, (bases, lengths, rec_valid))
        return state, keep, stats, tallies

    # ------------------------------------------------------------------
    def step(self, state, bases, lengths, rec_valid):
        return self._step(state, bases, lengths, rec_valid)

    def step_many(self, state, bases, lengths, rec_valid):
        return self._step_many(state, bases, lengths, rec_valid)

    def seed_step(self, state, bases, lengths):
        return self._seed(state, bases, lengths)
