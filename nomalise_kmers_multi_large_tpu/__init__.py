"""Accelerator digital normalization (diginorm) engine.

A JAX/XLA framework with the capabilities of the reference C tool
``alpapan/nomalise_kmers_multi_large`` (``normalise_kmers_multi_large.c``): streaming
digital normalization of paired-end / single-end Illumina FASTQ/FASTA reads.

Architecture (a batched device design, not a port):

- ``io``       host-side mmap FASTQ/FASTA reader, record framing, 2-bit packing,
               per-shard output writers (reference layers L1/L6).
- ``ops``      device compute: vectorized rolling k-mer encode, canonicalization,
               sort-based exact occurrence ranks, classification (reference L3/L4).
- ``table``    device-resident count tables: direct-address (collision-free, exact
               reference semantics) and hashed open-addressing with growth
               (reference L5, ``store_kmer``/``expand_local_hash_table``).
- ``models``   the normalization decision models (keep/skip policies; the reference's
               per-mate AND rule plus its commented-out pair-average variant).
- ``engine``   the streaming pipeline: batched host->device feed, jitted batch step,
               keep-mask driven output, progress/final reporting, checkpoint/resume.
- ``parallel`` device meshes and the two multi-chip strategies: Mode A (shard-local
               tables, data-parallel batches; generalizes the reference's independent
               per-thread tables) and Mode B (globally sharded exact table).
- ``cli``      argparse mirror of the reference's 16 flags.

Version constant mirrors the reference's ``VERSION`` (normalise_kmers_multi_large.c:1).
"""

VERSION = 20260817
REFERENCE_VERSION = 20240823


def _tune_host_allocator():
    """Keep large host buffers on the reused heap instead of fresh mmaps.

    The streaming engine allocates multi-MB staging buffers (packed batches,
    frame columns, emit blobs) every batch. glibc serves such allocations
    from fresh mmap regions by default, so every batch pays first-touch page
    faults; on virtualized hosts with on-demand paging (e.g. Firecracker
    microVMs) a fault costs tens of microseconds and caps ingest at
    ~0.2 GB/s — two orders of magnitude under the warm-page memory rate
    measured on the same machine. Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD
    makes glibc recycle warm heap pages instead (measured: 0.3 -> ~20 GB/s
    for the fresh-alloc copy pattern). No-op where unavailable (musl, macOS).
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6")
        m_trim_threshold, m_mmap_threshold = -1, -3
        libc.mallopt(m_mmap_threshold, 1 << 30)
        libc.mallopt(m_trim_threshold, 1 << 30)
    except (OSError, AttributeError):
        pass


_tune_host_allocator()

from nomalise_kmers_multi_large_tpu.config import Config  # noqa: E402,F401
