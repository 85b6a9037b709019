"""Multi-device streaming engine.

Extends the single-device Normalizer to a device mesh:

- Mode A ("local", default): one table shard per device (the reference's
  independent-per-thread model, normalise_kmers_multi_large.c README.md:68);
  every batch is row-sliced across devices, shard s writing to thread-s output
  files and seeing depth // n_devices as its threshold. Zero inter-device
  communication except the psum'd counters — scaling is linear by construction.
- Mode B ("global"): one exact table sharded over all devices by slot range;
  XLA GSPMD inserts the collectives. Single logical shard: thread-0 outputs,
  full-depth threshold, decisions identical to a single-device exact run.

The streaming loop itself is the parent Normalizer's (_run): staging queues,
--dispatch-group grouped dispatch, checkpoint/resume, -P dumps, debug record
lines and table growth (during seeding AND mid-stream: Mode A grows all
stacked shard tables together when the fullest one approaches headroom) all
come from there; this class only overrides the dispatch/retire/report hooks. Batches are padded to a multiple of the
device count with invalid records (length 0), which contribute nothing in
exact mode.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer
from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
from nomalise_kmers_multi_large_tpu.parallel.mesh import data_mesh
from nomalise_kmers_multi_large_tpu.parallel.modes import ModeAStep, ModeBStep


class MeshNormalizer(Normalizer):
    def __init__(self, cfg: Config, n_devices: int = 0):
        import jax

        ndev = n_devices or cfg.n_devices or jax.device_count()
        self.ndev = ndev
        self.mode_b = cfg.sharding == "global"
        if self.mode_b:
            eff = cfg if cfg.shards == 1 else dataclasses.replace(cfg, shards=1)
        else:
            # Mode A: one shard per device (reference cpus -> devices). The
            # reference lets the user pick the thread count (-p, nk.c:674) —
            # depth_per_cpu and output names depend on it — so an explicit
            # --cpu that disagrees with the device count is surfaced, not
            # silently overridden.
            if cfg.shards not in (1, ndev):
                print(
                    f"NOTE: --cpu {cfg.shards} overridden to the device "
                    f"count ({ndev}): mesh shards map 1:1 onto devices "
                    f"(depth/shard and output names follow the device "
                    f"count)", file=sys.stderr)
            eff = cfg if cfg.shards == ndev else dataclasses.replace(cfg, shards=ndev)
        super().__init__(eff, _single_state=True)
        self.mesh = data_mesh(ndev)
        self._mode_steps: dict = {}
        self._stacked = None       # Mode A stacked states
        self._global_state = None  # Mode B state
        self._resumed = False      # states hold per-shard checkpoint data

    # -- device dispatch ------------------------------------------------
    def _mode_step(self, paired: bool):
        key = paired
        if key not in self._mode_steps:
            base = BatchStep(
                self.tables[0],
                k=self.cfg.ksize,
                depth_per_shard=self.cfg.depth_per_shard,
                coverage=self.cfg.coverage,
                canonical=self.cfg.canonical,
                paired=paired,
                mode=self.cfg.mode,
                pair_rule=self.cfg.pair_rule,
                stride=self.cfg.stride,
            )
            cls = ModeBStep if self.mode_b else ModeAStep
            self._mode_steps[key] = cls(self.mesh, base)
        return self._mode_steps[key]

    def _ensure_states(self, paired: bool):
        """First dispatch: move the seeded (or resumed) shard states onto the
        mesh — Mode A replicates a fresh seed to every device (reference
        copy_hash_table) or stacks per-shard checkpoint states."""
        ms = self._mode_step(paired)
        if self.mode_b:
            if self._global_state is None:
                self._global_state = ms.stack_states(self.states) \
                    if self._resumed else ms.init_state(self.states[0])
                self.states = []
        else:
            if self._stacked is None:
                self._stacked = ms.stack_states(self.states) \
                    if self._resumed else ms.init_states(self.states[0])
                self.states = []

    def _queue_for(self, rr: int) -> int:
        return 0  # one staging queue: every dispatch spans all devices

    def _post_used_scalar(self, shard: int):
        """Live-occupancy feed for the growth mirror: the FULLEST shard's
        used (Mode A stacked states) or the global table's (Mode B). The
        max/copy is one tiny async device op per group dispatch."""
        import jax.numpy as jnp

        if self.mode_b:
            if self._global_state is not None \
                    and self._global_state.used is not None:
                return self._global_state.used.copy()
        elif self._stacked is not None and self._stacked.used is not None:
            return jnp.max(self._stacked.used)
        return super()._post_used_scalar(shard)

    def _maybe_grow(self, shard: int, inflow: int):
        import jax
        import jax.numpy as jnp

        if self._stacked is None and self._global_state is None and self.states:
            # before the states move onto the mesh (seed pass, TSV seeding)
            super()._maybe_grow(shard, inflow)
            return
        if self.mode_b:
            # direct is growth-free by construction; hashed Mode B growth is
            # not supported (starts at the --memory_start capacity;
            # saturation surfaces via the overflow warning)
            return
        if self._stacked is None:
            return
        # Mode A mid-stream growth: every shard shares one table descriptor,
        # so all stacked shard states grow TOGETHER when the fullest shard's
        # LIVE occupancy (the in-graph used counter, mirrored at every retire
        # via _post_used_scalar — see the base-class rationale for dropping
        # the old worst-case-inflow bound) crosses the headroom (reference
        # expand_local_hash_table semantics per thread, nk.c:933-934).
        t = self.tables[0]
        headroom = getattr(t, "grow_headroom", None)
        if headroom is None:
            return
        used = int(self._used_bound[0])  # fullest shard at last retire
        if used <= headroom * t.capacity:
            return
        shard_states = [
            jax.tree.map(lambda x, i=i: x[i], self._stacked)
            for i in range(self.ndev)
        ]
        grew = False
        while getattr(t, "can_grow", False) \
                and used > headroom * t.capacity:
            if self.cfg.verbose or self.cfg.debug:
                print(
                    f"Mesh: Local hash table expansion triggered on all "
                    f"{self.ndev} shards, from {t.capacity:,} to "
                    f"{t.capacity * 2:,} slots each"
                )
            grown_states = []
            for st in shard_states:
                # grow from the CURRENT descriptor `t`, not tables[0]: a
                # second doubling within one check must start from the
                # already-doubled capacity
                t2, st2 = t.grown(st)
                grown_states.append(st2)
            t = t2
            shard_states = grown_states
            grew = True
        if grew:
            self.tables = [t] * len(self.tables)
            self._stacked = jax.tree.map(
                lambda *xs: jnp.stack(xs), *shard_states)
            # old descriptors are baked into the compiled mode steps: rebuild
            self._mode_steps.clear()
            self._steps_cache.clear()
        if not getattr(t, "can_grow", False) and used > t.capacity * 0.9:
            print(
                f"Warning: Mesh: shard tables are still over 90% full after "
                f"expansion ({used:,})", file=sys.stderr,
            )

    def _dispatch_queue(self, shard: int, q: list, paired: bool):
        import jax.numpy as jnp

        self._ensure_states(paired)
        ms = self._mode_step(paired)
        padded = [
            self._pad_to_mesh(bases, lengths, rv, paired)
            for (_, bases, lengths, rv) in q
        ]
        state = self._global_state if self.mode_b else self._stacked
        if len(q) == 1:
            b, ln, rv, _ = padded[0]
            state, keep, stats, tallies = ms(
                state, jnp.asarray(b), jnp.asarray(ln), jnp.asarray(rv))
        else:
            bs = np.stack([p[0] for p in padded])
            ls = np.stack([p[1] for p in padded])
            rs = np.stack([p[2] for p in padded])
            state, keep, stats, tallies = ms.many(state, bs, ls, rs)
        if self.mode_b:
            self._global_state = state
        else:
            self._stacked = state
        return keep, stats, tallies

    def _pad_to_mesh(self, bases, lengths, rec_valid, paired):
        rpr = 2 if paired else 1
        b = rec_valid.shape[0]
        b_pad = -(-b // self.ndev) * self.ndev
        if b_pad != b:
            pad_rows = (b_pad - b) * rpr
            bases = np.concatenate(
                [bases, np.zeros((pad_rows, bases.shape[1]), bases.dtype)]
            )
            lengths = np.concatenate([lengths, np.zeros(pad_rows, lengths.dtype)])
            rec_valid = np.concatenate(
                [rec_valid, np.zeros(b_pad - b, rec_valid.dtype)]
            )
        return bases, lengths, rec_valid, b

    # -- retire ----------------------------------------------------------
    def _retire(self, batch, shard, keep_dev, stats_dev, tallies_dev,
                rec_valid=None) -> int:
        from nomalise_kmers_multi_large_tpu.engine.step import ReadTallies

        b_real = len(batch)
        rpr = 2 if batch.rev is not None else 1
        with self.timer.stage("device_wait"):
            keep = np.asarray(keep_dev)[:b_real]
            high = np.asarray(tallies_dev.high)
            total = np.asarray(tallies_dev.total)
        valid = rec_valid[:b_real] if rec_valid is not None else \
            np.ones(b_real, bool)

        if self.mode_b:
            with self.timer.stage("write"):
                self.writers[0].write_kept(batch, keep)
            c = self.counters[0]
            prev = c.processed
            c.processed += int(valid.sum())
            c.printed += int(keep.sum())
            c.skipped += int(valid.sum() - keep.sum())
            if self.cfg.debug > 1:
                self._debug_records(
                    batch, 0, keep, ReadTallies(high, total), prev)
            if c.due():
                self._refresh_unique_counts()
            c.maybe_report(self.cfg.verbose)
            return b_real

        # Mode A: record b of the padded batch belongs to device b // per
        b_pad = -(-b_real // self.ndev) * self.ndev
        per = b_pad // self.ndev
        due = any(c.due() for c in self.counters)
        if due:
            self._refresh_unique_counts()
        for s in range(self.ndev):
            lo, hi = s * per, min((s + 1) * per, b_real)
            if lo >= b_real:
                break
            sl = slice(lo, hi)
            sl_keep = np.zeros(b_real, bool)
            sl_keep[sl] = keep[sl]
            with self.timer.stage("write"):
                self.writers[s].write_kept(batch, sl_keep)
            c = self.counters[s]
            prev = c.processed
            nv = int(valid[sl].sum())
            nk = int(keep[sl].sum())
            c.processed += nv
            c.printed += nk
            c.skipped += nv - nk
            if self.cfg.debug > 1:
                sub = self._slice_batch(batch, lo, hi)
                self._debug_records(
                    sub, s, keep[sl],
                    ReadTallies(high[lo * rpr: hi * rpr],
                                total[lo * rpr: hi * rpr]),
                    prev,
                )
            c.maybe_report(self.cfg.verbose)
        return b_real

    # -- state materialization (checkpoints, -P dumps, reports) ----------
    def _install_resumed_states(self, states):
        self.states = states
        self._resumed = True

    def _materialized_states(self) -> list:
        import jax

        if self.mode_b:
            if self._global_state is None:
                return self.states
            return [self._global_state]
        if self._stacked is None:
            return self.states

        def shard(x, s):
            # shard s lives on device s: take it there. Indexing the stacked
            # array instead gathers every shard onto one device
            if x.is_fully_addressable:
                for sh in x.addressable_shards:
                    if sh.index[0].start == s:
                        return sh.data[0]
            return x[s]

        return [jax.tree.map(lambda x, s=s: shard(x, s), self._stacked)
                for s in range(self.ndev)]

    def _states_for_checkpoint(self):
        return self._materialized_states()

    def shard_state(self, s: int = 0):
        states = self._materialized_states()
        return states[s if not self.mode_b else 0]

    def _refresh_unique_counts(self):
        for s, state in enumerate(self._materialized_states()):
            self.counters[s].unique_kmers = self.tables[s].used_count(
                state, self.seeded_lo)
            if state.overflow is not None:
                self.counters[s].overflow = int(state.overflow)

    def _dump_tables(self):
        # the parent dump reads self.states
        saved = self.states
        self.states = self._materialized_states()
        try:
            super()._dump_tables()
        finally:
            self.states = saved
