"""The streaming normalization engine.

Orchestrates what the reference's ``main`` + thread layer does
(normalise_kmers_multi_large.c:2223-2455, :1772-1920): seed the table(s), open
per-shard outputs, stream each input file (pair) in record batches, run the jitted
device step, and write kept records — with JAX's async dispatch providing the
host/device overlap the reference gets from pthreads.

Shard model: ``--cpu N`` becomes N logical shards. Each shard owns an independent
table and output files and sees ``depth // N`` as its high-coverage threshold —
the reference's independent-per-thread design (README.md:68, depth_per_cpu :674).
Batches are dealt to shards round-robin (the reference deals contiguous byte
ranges; assignment is an internal detail — single-shard runs are bit-exact).
On a multi-device mesh the shards map onto devices (see parallel/).
"""
from __future__ import annotations

import sys
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine.report import RunReport, ShardCounters
from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
from nomalise_kmers_multi_large_tpu.io.pack import pack_batch
from nomalise_kmers_multi_large_tpu.io.reader import (
    FastxFile,
    RecordBatch,
    batch_iterator,
    paired_batch_iterator,
)
from nomalise_kmers_multi_large_tpu.io.writer import ShardWriter, output_filename
from nomalise_kmers_multi_large_tpu.ops.codec import (
    decode_codes,
    encode_windows_canonical,
    window_validity,
)
from nomalise_kmers_multi_large_tpu.table import DirectTable, make_table
from nomalise_kmers_multi_large_tpu.utils.prefetch import PrefetchIterator


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.jit, static_argnames=("k", "canonical"), donate_argnums=(0,))
def _mark_codes(marks, bases, lengths, k: int, canonical: bool):
    """marks[code] = 1 for every countable window code of a batch (k <= 15:
    codes index the lo plane; invalid windows are dropped)."""
    hi, lo = encode_windows_canonical(bases, k, canonical)
    valid = window_validity(lengths, hi, lo, k)
    idx = jnp.where(valid, lo.astype(jnp.int32), jnp.int32(-(2**31)))
    return marks.at[idx.ravel()].set(jnp.uint8(1), mode="drop")


class Normalizer:
    """Single-process engine (one device; N logical shards)."""

    def __init__(self, cfg: Config, _single_state: bool = False):
        self.cfg = cfg.validate()
        self.paired_any = bool(cfg.reverse_files)
        # identical descriptors are shared so shards share one compiled step;
        # a shard that grows gets its own descriptor (and its own compile)
        t0 = make_table(cfg)
        self.tables = [t0 for _ in range(cfg.shards)]
        # _single_state: mesh engines materialize one seedable state and
        # replicate it onto devices themselves (avoids shards x table allocs)
        if _single_state:
            self.states = [self.tables[0].init()]
        else:
            self.states = [t.init() for t in self.tables]
        self.steps: list[BatchStep] = []
        self.counters = [ShardCounters(s) for s in range(cfg.shards)]
        self.report = RunReport()
        self.writers: Optional[list[ShardWriter]] = None
        self.seeded_lo: Optional[np.ndarray] = None  # host set of seeded codes
        self._pad = 0  # adaptive padded read length (static per compiled step)
        self._warned_long_reads = False
        self._steps_cache: dict = {}
        #: host mirror of each shard's LIVE occupancy (state.used, maintained
        #: in-graph), refreshed at every retire; growth is gated on it with
        #: zero extra device syncs (see _maybe_grow)
        self._used_bound = [0.0] * cfg.shards
        #: windows dispatched since the last live fetch (seed pass only)
        self._unseen = [0.0] * cfg.shards
        self._in_seed = False
        self._grow_enabled = True
        #: host mirror of each shard's state.overflow at the last retire:
        #: a retire that observes growth here triggers grow-and-replay
        #: (_grow_and_replay) so an exhausted probe chain never loses
        #: inserts for the rest of the run (reference growth precedes loss,
        #: nk.c:933-934)
        self._overflow_seen = [0] * cfg.shards
        #: shards whose state was rewound+regrown by a replay during the
        #: current flush (the flush must re-dispatch its own staged group)
        self._replayed_shards: set[int] = set()
        #: --debug>2 per-upsert tier (reference nk.c:944,:1050): one exact
        #: host shadow table per shard, replayed at retire time
        self._shadows = None
        if cfg.debug > 2:
            from nomalise_kmers_multi_large_tpu.engine.debug_shadow import (
                UpsertShadow,
            )

            self._shadows = [UpsertShadow(cfg.ksize, cfg.canonical)
                             for _ in range(cfg.shards)]
        from nomalise_kmers_multi_large_tpu.utils.profiling import StageTimer

        self.timer = StageTimer()
        #: wall seconds per processed input file (pair) — the bench reads
        #: file 2+ of a multi-file run as the compile-free steady state
        self.file_walls: list[float] = []

    @staticmethod
    def _record_seq(file, cols, i: int) -> bytes:
        s0, sl = int(cols.seq_start[i]), int(cols.seq_len[i])
        return bytes(file.data[s0:s0 + sl])

    # ------------------------------------------------------------------
    def _get_step(self, shard: int, paired: bool) -> BatchStep:
        # keyed by table identity: shards sharing a descriptor share one
        # compiled step; growth swaps in a new descriptor => new step
        key = (paired, self.cfg.mode, id(self.tables[shard]))
        step = self._steps_cache.get(key)
        if step is None:
            step = BatchStep(
                self.tables[shard],
                k=self.cfg.ksize,
                depth_per_shard=self.cfg.depth_per_shard,
                coverage=self.cfg.coverage,
                canonical=self.cfg.canonical,
                paired=paired,
                mode=self.cfg.mode,
                pair_rule=self.cfg.pair_rule,
                stride=self.cfg.stride,
            )
            self._steps_cache[key] = step
        return step

    # ------------------------------------------------------------------
    def _maybe_grow(self, shard: int, inflow: int):
        """Grow a shard's table when LIVE occupancy crosses its headroom.

        The reference grows at 0.8 load factor on every insert
        (nk.c:933-934, expand_local_hash_table :1055-1108) and so never
        loses one. The equivalent trigger here is the live ``state.used``
        counter — maintained in-graph by the hashed table's inserts and
        mirrored to the host on every retire at zero extra sync cost.
        Gating on worst-case inflow instead (every dispatched window counted
        as a potential insert) balloons the table under large dispatch
        groups and recompiles the step at every doubling. The mirror is at
        most one in-flight group stale; inserts a dispatch drops in that
        window (probe chains exhausted) are recovered exactly by the
        overflow grow-and-replay protocol (_grow_and_replay).

        During the seed pass nothing retires, so the mirror is refreshed by
        a live scalar fetch whenever the dispatched windows could plausibly
        have crossed the budget (self-throttling: the fetch interval scales
        with capacity).
        """
        if not self._grow_enabled:
            return
        t = self.tables[shard]
        headroom = getattr(t, "grow_headroom", None)
        if headroom is None:
            return  # direct table: growth-free by construction
        budget = headroom * t.capacity
        if self._in_seed:
            self._unseen[shard] += inflow
            if self._used_bound[shard] + self._unseen[shard] > budget:
                st = self._pre_dispatch_state(shard)
                if st is not None and st.used is not None:
                    self._used_bound[shard] = float(int(st.used))
                self._unseen[shard] = 0.0
        if self._used_bound[shard] <= budget:
            return
        used = int(self._used_bound[shard])
        grew = False
        while getattr(t, "can_grow", False) and used > headroom * t.capacity:
            if self.cfg.verbose or self.cfg.debug:
                print(
                    f"Thread {shard}: Local hash table expansion triggered, "
                    f"from {t.capacity:,} to {t.capacity * 2:,}"
                )
            t, st = t.grown(self.states[shard])
            self.tables[shard] = t
            self.states[shard] = st
            grew = True
        if grew and (self.cfg.verbose or self.cfg.debug):
            print(
                f"Thread {shard}: Local hash table expansion completed "
                f"successfully, using {used:,} of {t.capacity:,} new capacity"
            )
        if not getattr(t, "can_grow", False) and used > t.capacity * 0.9:
            # reference warns when still >90% full after resizing (:1099-1102)
            print(
                f"Warning: Thread {shard}: Local hash table is still over 90% "
                f"full after expansion ({used:,})", file=sys.stderr,
            )

    def _pad_for(self, max_len: int) -> int:
        k = self.cfg.ksize
        need = max(int(max_len), k)
        if need > self.cfg.max_read_len and not self._warned_long_reads:
            # the device step counts at most max_read_len (1023) bases per
            # read (reference MAX_LINE_LENGTH nk.c:139, where longer lines are
            # a fatal framing error): the pad width is capped below, so we
            # write the record in full but windows past the cap do not
            # contribute to counts or the keep decision
            self._warned_long_reads = True
            print(
                f"Warning: reads longer than {self.cfg.max_read_len} bp "
                f"found (up to {need}); only the first "
                f"{self.cfg.max_read_len} bases of each read are counted "
                "(records are still written in full)", file=sys.stderr,
            )
        if self.cfg.pad_read_len:
            return self.cfg.pad_read_len
        need = min(need, max(self.cfg.max_read_len, k))
        if need > self._pad:
            # pad the WINDOW count only to a multiple of 8: the hot ops run on
            # the flattened [R*W] stream, where every padded window is a
            # full-price sentinel in sort/gather/scatter
            self._pad = _round_up(need + 1 - k, 8) + k - 1
        return self._pad

    # ------------------------------------------------------------------
    def _pack(self, batch: RecordBatch, min_len: int):
        """Pack a RecordBatch into device-ready arrays in reference stream order."""
        cfg = self.cfg
        if batch.rev is not None:
            pad = self._pad_for(
                max(batch.fwd.seq_len.max(initial=0), batch.rev.seq_len.max(initial=0))
            )
            fb, fl = pack_batch(
                batch.fwd_file.data, batch.fwd.seq_start, batch.fwd.seq_len,
                pad, min_len, threads=cfg.io_threads,
            )
            rb, rl = pack_batch(
                batch.rev_file.data, batch.rev.seq_start, batch.rev.seq_len,
                pad, min_len, threads=cfg.io_threads,
            )
            # reference drops the whole pair if EITHER mate is short (:1551-1566)
            rec_valid = (fl > 0) & (rl > 0)
            fl = np.where(rec_valid, fl, 0)
            rl = np.where(rec_valid, rl, 0)
            n = fb.shape[0]
            bases = np.empty((2 * n, pad), np.uint8)
            bases[0::2] = fb
            bases[1::2] = rb
            lengths = np.empty(2 * n, np.int32)
            lengths[0::2] = fl
            lengths[1::2] = rl
            return bases, lengths, rec_valid
        pad = self._pad_for(batch.fwd.seq_len.max(initial=0))
        fb, fl = pack_batch(
            batch.fwd_file.data, batch.fwd.seq_start, batch.fwd.seq_len,
            pad, min_len, threads=cfg.io_threads,
        )
        return fb, fl, fl > 0

    # ------------------------------------------------------------------
    def seed(self):
        """Sequential pre-pass (reference seed_kmer_hash, main :2242-2250): insert
        k-mers of the first records_to_seed records of EVERY input file with count
        0, so all shards start from an identical table. With --seed-table, the
        seed set comes from a k-mer TSV instead (the reference's planned feature,
        nk.c:74-77: "allow user to provide a tsv of kmers ... count is not
        relevant")."""
        cfg = self.cfg
        self._in_seed = True
        try:
            self._seed_impl_host()
        finally:
            self._in_seed = False

    def _seed_impl_host(self):
        cfg = self.cfg
        if cfg.seed_table:
            self._seed_from_tsv(cfg.seed_table)
            return
        n_seed = cfg.records_to_seed
        files = []
        for i, f in enumerate(cfg.forward_files):
            files.append(f)
            if i < len(cfg.reverse_files):
                files.append(cfg.reverse_files[i])

        marks = None  # direct table: device mark per seeded code
        for path in files:
            fx = FastxFile(path, cfg.is_input_fastq, cfg.io_threads)
            remaining = n_seed
            for batch in batch_iterator(fx, min(cfg.batch_reads, n_seed)):
                take = min(len(batch), remaining)
                if take < len(batch):
                    batch = RecordBatch(fwd_file=batch.fwd_file, fwd=batch.fwd.slice(0, take))
                if self._shadows is not None:
                    # reference prints its debug>2 upsert lines during the
                    # seed pass too (store_kmer do_init, nk.c:944)
                    for i in range(len(batch)):
                        self._shadows[0].seed_seq(
                            self._record_seq(batch.fwd_file, batch.fwd, i),
                            sys.stdout)
                # seeding uses the strictly-greater length rule (len > k, :1347)
                with self.timer.stage("seed"):
                    bases, lengths, _ = self._pack(batch, cfg.ksize + 1)
                    if isinstance(self.tables[0], DirectTable):
                        marks = self._mark_seeds(marks, bases, lengths)
                    else:
                        self._maybe_grow(
                            0, bases.shape[0] * (bases.shape[1] - cfg.ksize + 1))
                        # growth swaps the table descriptor; re-resolve the step
                        seed_step = self._get_step(0, paired=False)
                        self.states[0] = seed_step.seed_step(
                            self.states[0], bases, lengths)
                remaining -= take
                if remaining <= 0:
                    break

        if isinstance(self.tables[0], DirectTable):
            with self.timer.stage("seed"):
                self.seeded_lo = self._marked_codes(marks)
        else:
            with self.timer.stage("seed"):
                # drain the async seed dispatches so their device time is
                # attributed here, not to the first main-pass device_wait
                jax.block_until_ready(self.states[0])
                # prime the live-occupancy mirror from the seeded state
                if self.states[0].used is not None:
                    self._used_bound[0] = float(int(self.states[0].used))
            # replicate the seeded table to every shard (copy_hash_table
            # :908-927) — including any growth the seed pass triggered
            for s in range(1, len(self.states)):
                self.tables[s] = self.tables[0]
                self._used_bound[s] = self._used_bound[0]
                self.states[s] = jax.tree.map(lambda x: x.copy(), self.states[0])
        if self._shadows is not None:
            for s in range(1, len(self._shadows)):
                self._shadows[s] = self._shadows[0].copy()

    def _seed_from_tsv(self, path: str):
        """Seed from a kmer TSV (one kmer per line, optional count column)."""
        from nomalise_kmers_multi_large_tpu.io.pack import LUT

        cfg = self.cfg
        kmers = []
        with open(path, "rb") as f:
            for line in f:
                km = line.split(b"\t", 1)[0].strip()
                if len(km) == cfg.ksize:
                    kmers.append(km)
        if not kmers:
            self.seeded_lo = np.empty(0, np.uint32)
            return
        arr = LUT[np.frombuffer(b"".join(kmers), np.uint8)].reshape(
            len(kmers), cfg.ksize
        )
        if (arr == 255).any():
            raise ValueError(f"non-ACGTN kmer in seed table {path}")
        lengths = np.full(len(kmers), cfg.ksize, np.int32)
        if isinstance(self.tables[0], DirectTable):
            marks = None
            for i in range(0, len(arr), cfg.batch_reads):
                marks = self._mark_seeds(marks, arr[i: i + cfg.batch_reads],
                                         lengths[i: i + cfg.batch_reads])
            self.seeded_lo = self._marked_codes(marks)
        else:
            for i in range(0, len(arr), cfg.batch_reads):
                chunk = arr[i: i + cfg.batch_reads]
                self._maybe_grow(0, chunk.shape[0])
                step = self._get_step(0, paired=False)
                self.states[0] = step.seed_step(
                    self.states[0], chunk, lengths[i: i + cfg.batch_reads],
                )
            for s in range(1, cfg.shards):
                self.tables[s] = self.tables[0]
                self._used_bound[s] = self._used_bound[0]
                self.states[s] = jax.tree.map(lambda x: x.copy(), self.states[0])

    def _mark_seeds(self, marks, bases: np.ndarray, lengths: np.ndarray):
        """Direct-table seeding: set a device mark (uint8 [4^k]) for every
        countable code of a packed batch. The seeded set only feeds
        reporting (`used`) and the -P dumps, never a decision."""
        if marks is None:
            marks = jnp.zeros((4 ** self.cfg.ksize,), jnp.uint8)
        return _mark_codes(marks, bases, lengths, k=self.cfg.ksize,
                           canonical=self.cfg.canonical)

    @staticmethod
    def _marked_codes(marks) -> np.ndarray:
        """Sorted seeded codes (host uint32) from the device marks."""
        if marks is None:
            return np.empty(0, np.uint32)
        return np.flatnonzero(np.asarray(marks)).astype(np.uint32)

    # ------------------------------------------------------------------
    def run(self) -> RunReport:
        from nomalise_kmers_multi_large_tpu.utils.profiling import device_trace

        with device_trace(self.cfg.profile_dir or None):
            return self._run()

    def _run(self) -> RunReport:
        cfg = self.cfg
        from nomalise_kmers_multi_large_tpu.engine.checkpoint import CheckpointManager

        ckpt = CheckpointManager(cfg) if (cfg.checkpoint_every or cfg.resume) else None
        resume = None
        if cfg.resume and ckpt:
            loaded = ckpt.load()
            if loaded:
                states, resume = loaded
                self._install_resumed_states(states)
                self._rebuild_tables_from_states()
                self.seeded_lo = resume.seeded_lo
                self._reseed_used_bounds()
                for c, saved in zip(self.counters, resume.counters):
                    c.processed = saved["processed"]
                    c.printed = saved["printed"]
                    c.skipped = saved["skipped"]
                    c.unique_kmers = saved["unique_kmers"]
                print(
                    f"Resuming from checkpoint: file {resume.file_index + 1}, "
                    f"{resume.records_done:,} records done"
                )
                if self._shadows is not None:
                    if resume.shadows is not None:
                        # restore the per-shard debug>2 shadow tables: upsert
                        # counts stay ABSOLUTE across the resume
                        for sh, counts in zip(self._shadows, resume.shadows):
                            sh.counts = counts
                    else:
                        print(
                            "Warning: --debug>2 upsert lines after a resume "
                            "count from the resume point (this checkpoint "
                            "predates shadow snapshots)", file=sys.stderr,
                        )
        if resume is None:
            self.seed()
            if cfg.print_table:
                self._dump_seed_table()

        # baseline the overflow mirror: drops already in the seeded/resumed
        # states predate the main loop and cannot be replayed
        self._overflow_seen = [
            int(st.overflow) if getattr(st, "overflow", None) is not None
            else 0
            for st in self.states
        ] + [0] * max(0, cfg.shards - len(self.states))

        self.writers = [
            ShardWriter(cfg, s,
                        resume_sizes=resume.output_sizes if resume else None)
            for s in range(cfg.shards)
        ]

        rr = resume.rr if resume else 0  # round-robin shard cursor
        n_rev = len(cfg.reverse_files)
        batches_since_ckpt = 0
        for fi, fpath in enumerate(cfg.forward_files):
            if resume and fi < resume.file_index:
                continue
            t_file = time.perf_counter()
            paired = fi < n_rev
            if paired:
                print(
                    f"Processing file pair {fi + 1} of {len(cfg.forward_files)}: "
                    f"{fpath} and {cfg.reverse_files[fi]}"
                )
                fx = FastxFile(fpath, cfg.is_input_fastq, cfg.io_threads)
                rx = FastxFile(cfg.reverse_files[fi], cfg.is_input_fastq, cfg.io_threads)
                it = paired_batch_iterator(fx, rx, cfg.batch_reads)
            else:
                print(
                    f"Processing single-ended file {fi + 1} of "
                    f"{len(cfg.forward_files)}: {fpath}"
                )
                fx = FastxFile(fpath, cfg.is_input_fastq, cfg.io_threads)
                it = batch_iterator(fx, cfg.batch_reads)
            sys.stdout.flush()

            records_done = 0
            skip = resume.records_done if (resume and fi == resume.file_index) else 0
            resume_active = resume is not None and fi == resume.file_index
            if resume_active:
                resume = None  # consumed

            # in-flight double buffer: ([batches], shard, keep, stats, tallies)
            pending = None
            # per-shard staging queues for grouped dispatch (--dispatch-group):
            # G packed batches go to the device as ONE lax.scan call
            # (engine/step.py step_many), paying the per-dispatch runtime
            # cost once per group
            groups: dict[int, list] = {}

            def dispatch(shard: int, q: list):
                """One staged-group dispatch, bracketed by the state handles
                the overflow grow-and-replay protocol needs."""
                pre = self._replay_snapshot(shard)
                with self.timer.stage("dispatch"):
                    keep, stats, tallies = self._dispatch_queue(
                        shard, q, paired)
                post = self._pre_dispatch_state(shard)
                # copy the overflow/used scalars NOW: the state itself is
                # donated to the next dispatch before this one retires
                post_of = None
                if post is not None and post.overflow is not None:
                    post_of = post.overflow.copy()
                post_used = self._post_used_scalar(shard)
                return (q, shard, keep, stats, tallies, pre, post_of,
                        post_used)

            def flush_shard(shard: int) -> int:
                """Dispatch shard's staged batches; retire the previous
                in-flight dispatch. Returns records retired."""
                nonlocal pending
                q = groups.pop(shard, None)
                if not q:
                    return 0
                w = q[0][1].shape[1] - cfg.ksize + 1
                with self.timer.stage("grow_check"):
                    self._maybe_grow(shard, sum(x[1].shape[0] for x in q) * w)
                entry = dispatch(shard, q)
                done = 0
                if pending is not None:
                    done = self._retire_checked(pending, paired)
                    replayed, self._replayed_shards = self._replayed_shards, set()
                    if shard in replayed:
                        # the dispatch above consumed a state the replay just
                        # rewound: redo it on the grown table (only the
                        # current in-flight group can be invalidated — the
                        # flag dies with this flush)
                        entry = dispatch(shard, q)
                pending = entry
                return done

            def drain() -> int:
                """Flush every staged queue and retire everything in flight."""
                nonlocal pending
                done = 0
                for s in list(groups):
                    done += flush_shard(s)
                if pending is not None:
                    done += self._retire_checked(pending, paired)
                    self._replayed_shards.clear()
                    pending = None
                return done

            def produce(it=it):
                """frame+pack stage; runs on the prefetch worker when
                cfg.prefetch > 0 and overlaps device dispatch/wait (the
                consumer releases the GIL while blocked on the device)."""
                for batch in it:
                    with self.timer.stage("pack"):
                        packed = self._pack(batch, cfg.ksize)
                    yield batch, packed

            pit = (PrefetchIterator(produce(), depth=cfg.prefetch)
                   if cfg.prefetch > 0 else produce())
            try:
                src = iter(pit)
                while True:
                    # time blocked on the producer separately from the
                    # producer's own work: with a prefetch worker, "pack"
                    # accumulates on the worker thread (overlapped with
                    # device time) while produce_wait is the main thread's
                    # actual exposure to host ingest
                    try:
                        with self.timer.stage("produce_wait"):
                            batch, (bases, lengths, rec_valid) = next(src)
                    except StopIteration:
                        break
                    n = len(batch)
                    if skip:
                        take = min(skip, n)
                        skip -= take
                        records_done += take
                        if take == n:
                            continue
                        batch = self._slice_batch(batch, take, n)
                        n = len(batch)
                        # resume boundary (rare): re-pack the sliced batch
                        bases, lengths, rec_valid = self._pack(batch, cfg.ksize)
                    # checkpoint only when nothing is staged or in flight: the
                    # table state must describe exactly the records counted in
                    # records_done
                    if (
                        ckpt
                        and cfg.checkpoint_every
                        and batches_since_ckpt >= cfg.checkpoint_every
                    ):
                        records_done += drain()
                        self._checkpoint(ckpt, fi, records_done, rr)
                        batches_since_ckpt = 0
                    if cfg.debug >= 3:
                        self._debug_roundtrip(bases, lengths)
                    shard = self._queue_for(rr)
                    rr += 1
                    q = groups.setdefault(shard, [])
                    if q and q[0][1].shape != bases.shape:
                        # adaptive read-length padding changed the batch shape:
                        # a scan group must be shape-homogeneous
                        records_done += flush_shard(shard)
                        q = groups.setdefault(shard, [])
                    q.append((batch, bases, lengths, rec_valid))
                    batches_since_ckpt += 1
                    if len(q) >= cfg.dispatch_group:
                        records_done += flush_shard(shard)
            finally:
                # stop the prefetch worker on ANY exit (exception or
                # interrupt) so it never spins against a full queue
                if isinstance(pit, PrefetchIterator):
                    pit.close()
            records_done += drain()
            self.file_walls.append(time.perf_counter() - t_file)

            # per-file aggregation (reference :1896-1912); the unique-kmer
            # refresh is a device reduction + sync, so it gets its own stage
            with self.timer.stage("report"):
                self._refresh_unique_counts()
            self.report.absorb(self.counters)
            print(
                "Cumulative file statistics: "
                f"Processed {self.report.total_processed:,}, "
                f"Printed {self.report.total_printed:,}, "
                f"Skipped {self.report.total_skipped:,}, "
                f"Cumulative Max Unique Kmers in a thread: "
                f"{self.report.max_total_kmers:,}"
            )
            if ckpt and cfg.checkpoint_every:
                self._checkpoint(ckpt, fi + 1, 0, rr)

        if self.report.files_processed == 0:
            # resume found every file already done: the per-file absorb never
            # ran, but the restored counters still hold the run's totals
            self._refresh_unique_counts()
            self.report.absorb(self.counters)
        for c in self.counters:
            c.maybe_report(cfg.verbose, force=True)
        for w in self.writers:
            w.close()
        if cfg.print_table:
            self._dump_tables()
        if cfg.verbose or cfg.debug:
            rep = self.timer.report()
            if rep:
                print(rep)
        self.report.final(paired=n_rev > 0)
        return self.report

    @staticmethod
    def _slice_batch(batch: RecordBatch, lo: int, hi: int) -> RecordBatch:
        return RecordBatch(
            fwd_file=batch.fwd_file,
            fwd=batch.fwd.slice(lo, hi),
            rev_file=batch.rev_file,
            rev=batch.rev.slice(lo, hi) if batch.rev is not None else None,
        )

    def _queue_for(self, rr: int) -> int:
        """Staging queue (= shard) of the rr-th batch: round-robin deal. The
        mesh engine overrides this to a single queue (each dispatch spans all
        devices)."""
        return rr % self.cfg.shards

    def _install_resumed_states(self, states):
        self.states = states

    def _states_for_checkpoint(self):
        return self.states

    def _checkpoint(self, ckpt, file_index: int, records_done: int, rr: int):
        for w in self.writers:
            w.flush()
        self._refresh_unique_counts()
        paths = [p for w in self.writers for p in w.paths()]
        ckpt.save(self._states_for_checkpoint(), self.counters, file_index,
                  records_done, paths, rr, self.seeded_lo,
                  shadows=self._shadows)

    def _pre_dispatch_state(self, shard: int):
        """State handle bracketing a dispatch for the overflow grow-and-replay
        protocol. None disables replay (the mesh engines empty self.states
        once their stacked/global sharded states take over and keep the
        overflow-warning behavior instead)."""
        if not self.states or shard >= len(self.states):
            return None
        return self.states[shard]

    def _post_used_scalar(self, shard: int):
        """Live-occupancy scalar of the state a dispatch just produced,
        copied out before donation can consume it; retires feed it into the
        growth-gating mirror. Mesh engines override (fullest shard / global
        table)."""
        st = self._pre_dispatch_state(shard)
        if st is None or st.used is None:
            return None
        return st.used.copy()

    def _replay_snapshot(self, shard: int):
        """Device-side copy of the shard state, the replay source for
        overflow grow-and-replay: the jitted step DONATES its input state
        (in-place table aliasing), so the live buffers cannot be rewound.
        One async device copy of the table per group dispatch; skipped
        when replay could never apply."""
        st = self._pre_dispatch_state(shard)
        if st is None or st.overflow is None or not self._grow_enabled \
                or not getattr(self.tables[shard], "can_grow", False):
            return None
        return jax.tree.map(lambda x: x.copy(), st)

    def _retire_checked(self, entry, paired: bool) -> int:
        """Retire one dispatch, first checking its post-state overflow
        counter against the host mirror: growth there means probe chains
        ran out and the table dropped inserts — the results are discarded
        and the group replayed on a grown table (_grow_and_replay)."""
        q, shard, keep, stats, tallies, pre, post_of, post_used = entry
        replayed = False
        if pre is not None and post_of is not None:
            t = self.tables[shard]
            with self.timer.stage("device_wait"):
                # first sync point on this dispatch: blocks until the group
                # completes (the scalar itself is trivial)
                of_post = int(post_of)
            if of_post > self._overflow_seen[shard] \
                    and self._grow_enabled and getattr(t, "can_grow", False):
                keep, stats, tallies = self._grow_and_replay(
                    shard, q, paired, pre, of_post)
                replayed = True
            else:
                self._overflow_seen[shard] = of_post
        if post_used is not None and not replayed \
                and shard < len(self._used_bound):
            # refresh the live-occupancy mirror (growth gating) for free:
            # the retire already synced on this dispatch's outputs
            self._used_bound[shard] = float(int(post_used))
        return self._retire_group(
            [x[0] for x in q], shard, keep, stats, tallies,
            [x[3] for x in q])

    def _grow_and_replay(self, shard: int, q: list, paired: bool,
                         pre_state, of_post: int):
        """A dispatch dropped inserts (probe chains exhausted). The
        reference never loses an insert — growth precedes need
        (nk.c:933-934). Equivalent recovery here, exploiting immutability:
        the overflowing result is discarded, the table grows from the
        PRE-dispatch state, and the same batches
        replay on the grown table; the replay's decisions and counters are
        the ones retired. Loops (growing again from the pre-chain, never
        from a partially-dropped post state) until the replay is drop-free
        or the table can no longer grow."""
        of_base = self._overflow_seen[shard]
        t = self.tables[shard]
        print(
            f"Thread {shard}: table overflow "
            f"({of_post - of_base:,} dropped inserts): growing from "
            f"{t.capacity:,} slots and replaying the batch group",
            file=sys.stderr,
        )
        cur_t, cur_pre = t.grown(pre_state)
        while True:
            self.tables[shard] = cur_t
            # dispatch donates its input state: replay from a copy so
            # cur_pre survives for a further doubling if still overflowing
            self.states[shard] = jax.tree.map(lambda x: x.copy(), cur_pre)
            with self.timer.stage("dispatch"):
                keep, stats, tallies = self._dispatch_queue(shard, q, paired)
            of_new = int(self.states[shard].overflow)
            if of_new <= of_base or not getattr(cur_t, "can_grow", False):
                break
            cur_t, cur_pre = cur_t.grown(cur_pre)
        self._overflow_seen[shard] = of_new
        if self.states[shard].used is not None:
            self._used_bound[shard] = float(int(self.states[shard].used))
        self._replayed_shards.add(shard)
        return keep, stats, tallies

    def _dispatch_queue(self, shard: int, q: list, paired: bool):
        """Dispatch a staged queue to the device; overridden by the mesh
        engine (same staging/retire protocol, different device step)."""
        step = self._get_step(shard, paired)
        if len(q) == 1:
            _, bases, lengths, rv = q[0]
            self.states[shard], keep, stats, tallies = step.step(
                self.states[shard], bases, lengths, rv
            )
        else:
            bs = np.stack([x[1] for x in q])
            ls = np.stack([x[2] for x in q])
            rs = np.stack([x[3] for x in q])
            self.states[shard], keep, stats, tallies = step.step_many(
                self.states[shard], bs, ls, rs
            )
        return keep, stats, tallies

    def _retire_group(self, batches, shard, keep_dev, stats_dev,
                      tallies_dev, rec_valids) -> int:
        """Retire one dispatch: a single batch, or a step_many group whose
        outputs carry a leading G axis."""
        if len(batches) == 1:
            return self._retire(batches[0], shard, keep_dev, stats_dev,
                                tallies_dev, rec_valids[0])
        from nomalise_kmers_multi_large_tpu.engine.step import (
            ReadTallies,
            StepStats,
        )

        with self.timer.stage("device_wait"):
            keep = np.asarray(keep_dev)
            proc = np.asarray(stats_dev.processed)
            printed = np.asarray(stats_dev.printed)
            skipped = np.asarray(stats_dev.skipped)
            high = np.asarray(tallies_dev.high)
            total = np.asarray(tallies_dev.total)
        done = 0
        for g, b in enumerate(batches):
            done += self._retire(
                b, shard, keep[g],
                StepStats(proc[g], printed[g], skipped[g]),
                ReadTallies(high[g], total[g]),
                rec_valids[g],
            )
        return done

    def _retire(self, batch, shard, keep_dev, stats_dev, tallies_dev,
                rec_valid=None) -> int:
        with self.timer.stage("device_wait"):
            keep = np.asarray(keep_dev)
        with self.timer.stage("write"):
            self.writers[shard].write_kept(batch, keep)
        c = self.counters[shard]
        prev_processed = c.processed
        c.processed += int(stats_dev.processed)
        c.printed += int(stats_dev.printed)
        c.skipped += int(stats_dev.skipped)
        if self.cfg.debug > 1:
            self._debug_records(batch, shard, keep, tallies_dev, prev_processed)
        if c.due():
            # refresh live table occupancy so the 60 s verbose line reports
            # current unique k-mers (reference reads ht->used live,
            # nk.c:1715-1723), not the last file-boundary snapshot
            c.unique_kmers = self.tables[shard].used_count(
                self.states[shard], self.seeded_lo
            )
        c.maybe_report(self.cfg.verbose)
        return len(batch)

    def _debug_records(self, batch, shard, keep, tallies_dev, base_count):
        """Per-record PRINTED/SKIPPED lines (reference debug>1, nk.c:1677-1696)."""
        high = np.asarray(tallies_dev.high)
        total = np.asarray(tallies_dev.total)
        paired = batch.rev is not None
        d = self.cfg.depth_per_shard
        seq_no = base_count
        for i in range(len(batch)):
            if paired:
                hf, tf = int(high[2 * i]), int(total[2 * i])
                hr, tr = int(high[2 * i + 1]), int(total[2 * i + 1])
                if tf == 0 and tr == 0 and not keep[i]:
                    continue  # invalid record: reference skips silently
                if self._shadows is not None:
                    # per-upsert lines precede the verdict line, exactly as
                    # the reference's store_kmer prints inside the hot loop
                    # (fwd mate then rev, nk.c:1559,:1563)
                    sh = self._shadows[shard]
                    sh.process_seq(
                        self._record_seq(batch.fwd_file, batch.fwd, i),
                        sys.stdout)
                    sh.process_seq(
                        self._record_seq(batch.rev_file, batch.rev, i),
                        sys.stdout)
                seq_no += 1
                verdict = "PRINTED" if keep[i] else "SKIPPED"
                rf = hf / tf if tf else 0.0
                rv = hr / tr if tr else 0.0
                print(
                    f"Thread {shard} - Sequence pair {seq_no:,} {verdict}: "
                    f"High ({d}) count kmers: F:{hf};R:{hr}, "
                    f"Total kmers: F:{tf};R:{tr} "
                    f"High count ratio: F:{rf:.2f};R:{rv:.2f}"
                )
                if self.cfg.debug > 3:
                    self._debug_dump_seq(batch, i)
            else:
                h, t = int(high[i]), int(total[i])
                if t == 0 and not keep[i]:
                    continue
                if self._shadows is not None:
                    self._shadows[shard].process_seq(
                        self._record_seq(batch.fwd_file, batch.fwd, i),
                        sys.stdout)
                seq_no += 1
                verdict = "PRINTED" if keep[i] else "SKIPPED"
                r = h / t if t else 0.0
                print(
                    f"Thread {shard} - Sequence {seq_no:,} {verdict}: "
                    f"High ({d}) count kmers: F:{h}, Total kmers: F:{t} "
                    f"High count ratio: F:{r:.2f}"
                )
                if self.cfg.debug > 3:
                    self._debug_dump_seq(batch, i)

    def _debug_dump_seq(self, batch, i: int):
        """--debug > 3 raw record dump (reference nk.c:1694-1695). The
        per-upsert hash/count lines at debug>2 come from the host shadow
        table (engine/debug_shadow.py, byte-identical to the reference's);
        the probe-chain traces at debug>4 (nk.c:1034) have no analogue — the
        device tables probe in whole-stream rounds, not per k-mer — and their
        role is served by the debug>=3 batch-level decode(encode)
        self-checks (_debug_roundtrip)."""

        def seq(file, cols):
            h0 = int(cols.hdr_start[i])
            s0, sl = int(cols.seq_start[i]), int(cols.seq_len[i])
            hdr = bytes(file.data[h0:int(cols.hdr_len[i]) + h0]).decode(
                "ascii", "replace")
            sq = bytes(file.data[s0:s0 + sl]).decode("ascii", "replace")
            return hdr, sq

        fh, fs = seq(batch.fwd_file, batch.fwd)
        if batch.rev is not None:
            rh, rs = seq(batch.rev_file, batch.rev)
            print(f"FWD seq: {fh}\n{fs}\nREV seq: {rh}\n{rs}")
        else:
            print(f"FWD seq: {fh}\n{fs}")

    def _reseed_used_bounds(self):
        """After resume, prime the host-side occupancy bounds from the real
        checkpointed occupancy. Left at 0.0 the engine could dispatch up to
        headroom*capacity windows with no growth check and a table resumed
        near its trigger point could saturate (silently dropped inserts)."""
        for s, st in enumerate(self.states):
            t = self.tables[min(s, len(self.tables) - 1)]
            if getattr(t, "grow_headroom", None) is None:
                continue
            b = float(t.used_count(st, self.seeded_lo))
            # re-baseline the LIVE counter from the table itself
            if st.used is not None:
                self.states[s] = st._replace(
                    used=jnp.asarray(int(b), jnp.int32))
            if s < len(self._used_bound):
                self._used_bound[s] = b
        # mesh engines gate every growth check on bound[0] (shared descriptor):
        # it must reflect the FULLEST shard
        if len(self.states) > 1 and len(self._used_bound) >= 1 \
                and getattr(self.tables[0], "grow_headroom", None) is not None:
            self._used_bound[0] = max(
                self._used_bound[s] for s in range(
                    min(len(self.states), len(self._used_bound))))

    def _rebuild_tables_from_states(self):
        """After resume, table descriptors must match the (possibly grown)
        checkpointed state shapes."""
        from nomalise_kmers_multi_large_tpu.table.hashed import HashedTable

        for s, st in enumerate(self.states):
            t = self.tables[s]
            if isinstance(t, HashedTable) and st.counts.shape[0] != t.capacity:
                self.tables[s] = HashedTable(t.k, int(st.counts.shape[0]))

    def _debug_roundtrip(self, bases, lengths):
        """--debug >= 3 inline self-check (reference nk.c:950-960, 976-991):
        the reference cross-checks decode(encode(kmer)) for every stored k-mer
        and exits on mismatch. Device analogue, per batch: run the production
        device encode, decode every counted code back to a string on the host,
        and re-encode it with an independent host path."""
        from nomalise_kmers_multi_large_tpu.io.pack import LUT

        cfg = self.cfg
        k = cfg.ksize
        hi, lo = encode_windows_canonical(jnp.asarray(bases), k, cfg.canonical)
        valid = np.asarray(window_validity(jnp.asarray(lengths), hi, lo, k))
        hi, lo = np.asarray(hi), np.asarray(lo)
        vhi, vlo = hi[valid], lo[valid]
        if vhi.size:
            kmers = decode_codes(vhi, vlo, k)
            arr = LUT[
                np.frombuffer("".join(kmers).encode(), np.uint8)
            ].reshape(len(kmers), k).astype(np.uint64)
            code2 = np.zeros(len(kmers), np.uint64)
            for j in range(k):
                code2 = (code2 << np.uint64(2)) | arr[:, j]
            bad = ((code2 & np.uint64(0xFFFFFFFF)).astype(np.uint32) != vlo) | (
                (code2 >> np.uint64(32)).astype(np.uint32) != vhi
            )
            if bad.any():
                i = int(np.argmax(bad))
                # reference exits on mismatch (nk.c:957-959)
                raise SystemExit(
                    f"FATAL: kmers do not match hash: {kmers[i]} vs "
                    f"{(int(vhi[i]) << 32) | int(vlo[i])}"
                )

    def _refresh_unique_counts(self):
        for s in range(self.cfg.shards):
            t = self.tables[s]
            self.counters[s].unique_kmers = t.used_count(self.states[s], self.seeded_lo)
            st = self.states[s]
            if st.overflow is not None:
                self.counters[s].overflow = int(st.overflow)

    def shard_state(self, s: int = 0):
        return self.states[s]

    # ------------------------------------------------------------------
    def _dump_seed_table(self):
        """-P seed dump: output_kmer_seeds.k{k}_norm{d}.tsv with count 0 rows
        (print_kmer_table :354-385 via main :2251)."""
        cfg = self.cfg
        path = output_filename(
            "output_kmer_seeds", cfg.ksize, cfg.depth_per_shard, -1, "tsv"
        )
        import os

        path = os.path.join(cfg.out_dir, path)
        if self.seeded_lo is not None:
            hi = np.zeros_like(self.seeded_lo)
            kmers = decode_codes(hi, self.seeded_lo, cfg.ksize)
            counts = np.zeros(len(kmers), np.int32)
        else:
            h, l, counts = self.tables[0].export(self.states[0])
            kmers = decode_codes(h, l, cfg.ksize)
            counts = np.zeros(len(kmers), np.int32)
        with open(path, "w") as f:
            for km, c in zip(kmers, counts):
                f.write(f"{km}\t{c}\n")

    def _dump_tables(self):
        cfg = self.cfg
        import os

        for s in range(cfg.shards):
            h, l, counts = self.tables[s].export(self.states[s], self.seeded_lo)
            kmers = decode_codes(h, l, cfg.ksize)
            path = os.path.join(
                cfg.out_dir,
                output_filename("output_kmer", cfg.ksize, cfg.depth_per_shard, s, "tsv"),
            )
            with open(path, "w") as f:
                for km, c in zip(kmers, counts):
                    f.write(f"{km}\t{c}\n")


def run(cfg: Config) -> RunReport:
    """Entry point: picks the single-device or mesh engine."""
    import jax

    ndev = cfg.n_devices or jax.device_count()
    if ndev > 1:
        from nomalise_kmers_multi_large_tpu.parallel.engine import MeshNormalizer

        return MeshNormalizer(cfg, ndev).run()
    return Normalizer(cfg).run()
