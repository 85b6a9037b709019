from nomalise_kmers_multi_large_tpu.table.direct import DirectTable  # noqa: F401
from nomalise_kmers_multi_large_tpu.table.hashed import HashedTable  # noqa: F401
from nomalise_kmers_multi_large_tpu.table.base import CountTable, TableState  # noqa: F401


def make_table(cfg) -> "CountTable":
    """Pick the table implementation for a config.

    - "direct": dense 4^k int32 array (k<=15) — the layout the reference's
      own sizing advice degenerates to (normalise_kmers_multi_large.c:20-22).
    - "hashed": open-addressing table with device growth for k>15.
    """
    if cfg.table_kind == "direct":
        return DirectTable(k=cfg.ksize)
    return HashedTable(k=cfg.ksize, initial_capacity=cfg.initial_hash_capacity)
