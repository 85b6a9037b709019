"""Multi-host support.

The reference is strictly single-process (SURVEY.md section 2.3); scaling
across hosts is new surface. Model: each host process runs the streaming
engine over ITS OWN subset of the input file list (file-level data
parallelism — diginorm's per-thread-independent semantics make this exact for
Mode A), with the mesh spanning all processes' devices for Mode B.

Launch: set the standard JAX cluster env (JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES, JAX_PROCESS_ID), then run the same CLI on every host. `maybe_initialize` is a no-op in single-process
runs, so the code path is identical everywhere.
"""
from __future__ import annotations

import os


def maybe_initialize() -> tuple[int, int]:
    """Initialize jax.distributed when a cluster env is present.

    Returns (process_index, process_count).
    """
    import jax

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if addr:
        nproc = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        if nproc is None or pid is None:
            # no cluster auto-detection to fall back on: say what is missing
            raise ValueError(
                "JAX_COORDINATOR_ADDRESS needs JAX_NUM_PROCESSES and "
                "JAX_PROCESS_ID set beside it")
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(pid),
        )
    try:
        return jax.process_index(), jax.process_count()
    except RuntimeError:
        return 0, 1


def assign_files(
    forward: tuple[str, ...],
    reverse: tuple[str, ...],
    process_index: int,
    process_count: int,
) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Deal input file (pairs) round-robin across host processes.

    Pairing is preserved: file i keeps its mate. Unmatched single-end tails
    (the --single mixed mode) ride with their forward file.
    """
    if process_count <= 1:
        return forward, reverse
    fwd = tuple(f for i, f in enumerate(forward) if i % process_count == process_index)
    rev = tuple(
        r for i, r in enumerate(reverse) if i % process_count == process_index
    )
    return fwd, rev


def aggregate_report(report, paired: bool):
    """Sum printed/skipped/processed across hosts (the reference's per-thread
    counter aggregation, nk.c:1896-1912, lifted to processes). Uses a tiny
    psum over the global device mesh; single-process runs return unchanged."""
    import jax

    if jax.process_count() <= 1:
        return report
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    # 64-bit-safe regardless of jax_enable_x64: the reference's flagship run
    # processed 2,987,923,777 records (README.md:74) > 2^31, so int32 device
    # counters would wrap. Ship each counter as two 31-bit int32 halves and
    # recombine host-side in Python ints.
    vals = [int(report.total_processed), int(report.total_printed),
            int(report.total_skipped), int(report.max_total_kmers)]
    halves = jnp.array(
        [[v & 0x7FFFFFFF, v >> 31] for v in vals], jnp.int32)
    g = np.asarray(multihost_utils.process_allgather(halves)).astype(np.int64)
    gathered = g[..., 0] + (g[..., 1] << np.int64(31))   # [P, 4]
    report.total_processed = int(gathered[:, 0].sum())
    report.total_printed = int(gathered[:, 1].sum())
    report.total_skipped = int(gathered[:, 2].sum())
    report.max_total_kmers = int(gathered[:, 3].max())
    return report
