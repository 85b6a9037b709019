"""K-mer spectrum analytics on direct and hashed tables."""
import numpy as np
import jax.numpy as jnp

from nomalise_kmers_multi_large_tpu.models.spectrum import spectrum
from nomalise_kmers_multi_large_tpu.ops.streamrank import sorted_occurrence_stream
from nomalise_kmers_multi_large_tpu.table import DirectTable, HashedTable


def _stream(codes):
    codes = np.asarray(codes, np.uint64)
    hi = (codes >> 32).astype(np.uint32)
    lo = (codes & 0xFFFFFFFF).astype(np.uint32)
    return sorted_occurrence_stream(
        jnp.asarray(hi), jnp.asarray(lo), jnp.ones(len(codes), bool)
    )


def test_spectrum_direct():
    t = DirectTable(7)
    s = t.init()
    # 3 kmers seen 1x, 2 seen 5x, 1 seen 10x
    codes = [1, 2, 3] + [4] * 5 + [5] * 5 + [6] * 10
    s, _ = t.count_and_update(s, _stream(codes))
    sp = spectrum(t, s)
    assert sp.distinct_kmers == 6
    assert sp.total_kmers == len(codes)
    assert sp.histogram[1] == 3 and sp.histogram[5] == 2 and sp.histogram[10] == 1
    assert sp.coverage_peak == 5  # peak past the multiplicity-1 error band


def test_spectrum_hashed_with_seeds():
    t = HashedTable(7, 1 << 10)
    s = t.init()
    s, _ = t.count_and_update(s, _stream([7, 8, 9]), seed=True)
    s, _ = t.count_and_update(s, _stream([7, 7, 7]))
    sp = spectrum(t, s)
    assert sp.histogram[0] == 2  # seeded, never seen
    assert sp.histogram[3] == 1
    assert sp.distinct_kmers == 1  # counted kmers only
    assert sp.total_kmers == 3


def test_spectrum_hashed_wide():
    """Two-plane (k > 15) codes in the hashed table: occupancy comes from
    both key planes, so codes with a zero lo plane still count."""
    k = 21
    t = HashedTable(k, 1 << 10)
    s = t.init()
    big = 1 << 40
    codes = ([big + 1, big + 2, 1 << 32] + [big + 4] * 5 + [big + 5] * 5
             + [3] * 10)
    s, _ = t.count_and_update(s, _stream(codes))
    sp = spectrum(t, s)
    assert sp.distinct_kmers == 6
    assert sp.total_kmers == len(codes)
    assert sp.histogram[1] == 3 and sp.histogram[5] == 2 and sp.histogram[10] == 1
    assert sp.coverage_peak == 5
