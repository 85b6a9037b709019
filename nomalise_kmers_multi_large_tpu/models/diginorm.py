"""The digital-normalization decision model.

Pure functions mapping per-read (high_count_kmers, total_kmers) tallies to
keep/skip decisions — the reference's classification math
(normalise_kmers_multi_large.c:1641-1646 paired, :1986-1992 single):

- ratio = total > 0 ? high / total : 0   (float; :1641-1642)
- keep a single read iff ratio < coverage         (STRICT <, so --coverage 1 drops
  only exact 100% redundancy; CHANGELOG.md:2)
- keep a pair iff ratio_fwd < coverage AND ratio_rev < coverage (:1646)

The ratio is float32 (IEEE, correctly rounded) compared with float32(coverage).
A device's compiled f32 divide need not round like IEEE division (on the GPU it
differs in a few cases per coverage), and a ratio that lands on the coverage
(9/10 vs 0.9) then flips.
So the rule is evaluated on the host once per coverage as an integer table —
keep iff high < threshold[total] — and the device only looks it up.

`rule="avg"` implements the reference's commented-out alternative — classify on the
pair-pooled ratio (:1638-1645) — exposed as a real option here.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

#: the reference's longest read is 1023 bases, so a read has at most 1023
#: windows and a pooled pair at most twice that
MAX_TOTAL = 2 * 1023


@functools.lru_cache(maxsize=None)
def keep_thresholds(coverage: float, max_total: int = MAX_TOTAL) -> np.ndarray:
    """int32 [max_total + 1]: a read with `high` of its `total` windows at
    depth is kept iff high < thresholds[total], i.e. iff
    f32(high) / f32(total) < f32(coverage); total = 0 has ratio 0 (kept)."""
    t = np.arange(1, max_total + 1, dtype=np.float32)[:, None]
    h = np.arange(max_total + 1, dtype=np.float32)[None, :]
    # the ratio grows with high, so the kept highs are a prefix per total
    below = (h / t) < np.float32(coverage)
    return np.concatenate([[1], below.sum(axis=1)]).astype(np.int32)


def keep_mask_single(high, total, coverage: float,
                     max_total: int = MAX_TOTAL) -> jnp.ndarray:
    """Keep mask of single reads; every total must be <= max_total."""
    thr = jnp.asarray(keep_thresholds(float(coverage), int(max_total)))
    return high < thr[jnp.clip(total, 0, max_total)]


def keep_mask_paired(high_f, total_f, high_r, total_r, coverage: float,
                     rule: str = "and",
                     max_total: int = MAX_TOTAL) -> jnp.ndarray:
    """Keep mask of pairs; every mate's total must be <= max_total."""
    if rule == "avg":
        return keep_mask_single(high_f + high_r, total_f + total_r, coverage,
                                2 * max_total)
    return (keep_mask_single(high_f, total_f, coverage, max_total)
            & keep_mask_single(high_r, total_r, coverage, max_total))
