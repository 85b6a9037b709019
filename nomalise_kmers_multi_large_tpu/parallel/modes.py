"""Multi-device normalization steps.

Mode A — shard-local tables (the reference's independent-per-thread design
generalized to a device mesh): every device runs the full batch step on its slice
of the read batch against its own private table; nothing crosses the interconnect
except the scalar printed/skipped counters (one psum), exactly mirroring the
reference's join-and-sum (normalise_kmers_multi_large.c:1896-1912). Decisions use
``depth // n_shards`` like the reference's depth_per_cpu (:674).

Mode B — one globally-sharded exact table: the count array lives sharded across
devices on the slot axis while batches stay data-parallel. The step runs under
jit with sharding constraints and XLA GSPMD partitions the sort/gather/scatter,
inserting the all-to-all/all-gather collectives itself in place of hand-written
k-mer routing.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nomalise_kmers_multi_large_tpu.engine.step import BatchStep, StepStats
from nomalise_kmers_multi_large_tpu.table.base import TableState


class ModeAStep:
    """shard_map-wrapped BatchStep: [S, ...] stacked table states, batches sharded
    on the leading row axis."""

    def __init__(self, mesh: Mesh, step: BatchStep):
        self.mesh = mesh
        self.step = step
        self.n = mesh.shape["data"]

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data")),
            out_specs=(P("data"), P("data"), P(), P("data")),
            # per-shard table contents legitimately diverge across 'data'; disable
            # the varying-manual-axes check (the while_loop carries in the hashed
            # table would otherwise need per-axis pvary annotations)
            check_vma=False,
        )
        def _sharded(state, bases, lengths, rec_valid):
            local = jax.tree.map(lambda x: x[0], state)
            local, keep, stats, tallies = step._step_impl(
                local, bases, lengths, rec_valid
            )
            stats = StepStats(
                *(jax.lax.psum(s, "data") for s in stats)
            )
            return jax.tree.map(lambda x: x[None], local), keep, stats, tallies

        self._fn = jax.jit(_sharded, donate_argnums=(0,))

        def _many(state, bs, ls, rs):
            # G sequential mesh steps in ONE dispatch (engine/step.py
            # step_many, lifted over the shard_map)
            def body(st, xs):
                st, keep, stats, tallies = _sharded(st, *xs)
                return st, (keep, stats, tallies)

            state, (keep, stats, tallies) = jax.lax.scan(body, state, (bs, ls, rs))
            return state, keep, stats, tallies

        self._fn_many = jax.jit(_many, donate_argnums=(0,))

    def init_states(self, base: TableState | None = None) -> TableState:
        """[S, ...]-stacked states, one per device. `base` (e.g. a seeded table,
        reference copy_hash_table :908-927) is replicated to every shard."""
        one = base if base is not None else self.step.table.init()
        return self.stack_states([one] * self.n)

    def stack_states(self, states: list) -> TableState:
        """Stack per-shard states (e.g. from a checkpoint) onto the mesh,
        copying shard s straight to device s: the stacked array is never
        materialized on one device (S tables at once would not fit)."""
        assert len(states) == self.n
        sh = NamedSharding(self.mesh, P("data"))
        devs = list(self.mesh.devices.flat)

        def place(*xs):
            shards = [jax.device_put(x, d)[None] for x, d in zip(xs, devs)]
            return jax.make_array_from_single_device_arrays(
                (self.n,) + xs[0].shape, sh, shards)

        return jax.tree.map(place, *states)

    def __call__(self, state, bases, lengths, rec_valid):
        sh = NamedSharding(self.mesh, P("data"))
        return self._fn(
            state,
            jax.device_put(bases, sh),
            jax.device_put(lengths, sh),
            jax.device_put(rec_valid, sh),
        )

    def many(self, state, bs, ls, rs):
        """Grouped dispatch: leading G axis on every operand."""
        sh = NamedSharding(self.mesh, P(None, "data"))
        return self._fn_many(
            state,
            jax.device_put(bs, sh),
            jax.device_put(ls, sh),
            jax.device_put(rs, sh),
        )


class ModeBStep:
    """Globally sharded exact table: jit + sharding constraints, GSPMD collectives."""

    def __init__(self, mesh: Mesh, step: BatchStep):
        self.mesh = mesh
        self.step = step
        self._data_sh = NamedSharding(mesh, P("data"))

        def _spec(x):
            # counts [C] shard on slots; hashed keys [2, C] shard on slot axis 1;
            # scalars replicate
            if x.ndim == 1:
                return NamedSharding(mesh, P("data"))
            if x.ndim == 2:
                return NamedSharding(mesh, P(None, "data"))
            return NamedSharding(mesh, P())

        self._spec = _spec

        def _fn(state, bases, lengths, rec_valid):
            state = jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, _spec(x)), state
            )
            bases = jax.lax.with_sharding_constraint(bases, self._data_sh)
            return step._step_impl(state, bases, lengths, rec_valid)

        self._fn = jax.jit(_fn, donate_argnums=(0,))

        def _many(state, bs, ls, rs):
            def body(st, xs):
                st, keep, stats, tallies = _fn(st, *xs)
                return st, (keep, stats, tallies)

            state, (keep, stats, tallies) = jax.lax.scan(body, state, (bs, ls, rs))
            return state, keep, stats, tallies

        self._fn_many = jax.jit(_many, donate_argnums=(0,))

    def init_state(self, base: TableState | None = None) -> TableState:
        state = base if base is not None else self.step.table.init()
        return jax.tree.map(lambda x: jax.device_put(x, self._spec(x)), state)

    def stack_states(self, states: list) -> TableState:
        """Mode B has one logical shard; install its checkpointed state."""
        assert len(states) == 1
        return self.init_state(states[0])

    def __call__(self, state, bases, lengths, rec_valid):
        return self._fn(state, bases, lengths, rec_valid)

    def many(self, state, bs, ls, rs):
        return self._fn_many(state, bs, ls, rs)
