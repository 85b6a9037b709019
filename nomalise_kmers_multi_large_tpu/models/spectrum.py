"""K-mer spectrum analytics.

The reference wishes for this ("every species has a unique kmer spectrum ...
at the very least get a histogram of collisions and a map of occupied
indexes", normalise_kmers_multi_large.c:85-90) but never implements it. Here:
an on-device count-of-counts histogram over the table plus the classic
spectrum-derived estimates (coverage peak, distinct/total k-mers, an
Illumina-style genome-size estimate).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SpectrumReport(NamedTuple):
    histogram: np.ndarray     # [max_count+1] count-of-counts; index = multiplicity
    distinct_kmers: int
    total_kmers: int          # sum of counts
    coverage_peak: int        # multiplicity of the non-error spectrum peak
    genome_size_estimate: int  # total_kmers / coverage_peak (0 if no peak)


from functools import partial


@partial(jax.jit, static_argnums=(1,))
def _histogram(counts: jnp.ndarray, max_count: int = 1024) -> jnp.ndarray:
    c = jnp.clip(counts.reshape(-1), 0, max_count)
    return jnp.bincount(c, length=max_count + 1)


def spectrum(table, state, max_count: int = 1024) -> SpectrumReport:
    """Compute the spectrum of a table shard (direct or hashed)."""
    if state.keys is None:
        # direct table: slot == code; a zero count just means unseen
        hist = np.asarray(_histogram(state.counts, max_count))
        hist = hist.copy()
        hist[0] = 0  # empty slots are not multiplicity-0 k-mers
    else:
        # hashed: keys uint32 [2, capacity] (hi, lo) planes
        occupied = (state.keys[0] | state.keys[1]) != jnp.uint32(0)
        cnt = jnp.where(occupied, state.counts, -1)
        hist = np.asarray(_histogram(cnt, max_count))
        hist = hist.copy()
        hist[0] = int(jnp.sum(occupied & (state.counts == 0)))  # seeded, unseen

    distinct = int(hist[1:].sum())
    total = int((hist * np.arange(hist.shape[0], dtype=np.int64)).sum())
    # non-error peak: largest multiplicity >= 2 local maximum after the error
    # valley (standard k-mer spectrum heuristic)
    peak = 0
    if hist[2:].any():
        h = hist[1:].astype(np.float64)
        valley = 1
        while valley + 1 < h.shape[0] and h[valley] > h[valley + 1]:
            valley += 1
        if valley + 1 < h.shape[0]:
            peak = int(np.argmax(h[valley:]) + valley + 1)
    genome = int(total // peak) if peak else 0
    return SpectrumReport(
        histogram=hist,
        distinct_kmers=distinct,
        total_kmers=total,
        coverage_peak=peak,
        genome_size_estimate=genome,
    )
