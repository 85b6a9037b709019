"""Device mesh construction.

The reference's only parallelism is pthread data-parallelism with per-thread
tables and zero communication (normalise_kmers_multi_large.c:1772-1920,
README.md:68). The device equivalents (SURVEY.md section 2.3):

- Mode A ("local"): a 1-D ``data`` mesh; each device owns an independent table
  shard and a slice of every batch; only scalar counters cross devices (psum).
- Mode B ("global"): same mesh, but ONE exact count table sharded over devices by
  slot range; XLA partitions the gather/scatter and emits the collectives.

Multi-host: ``jax.distributed.initialize`` is called by the launcher when
JAX_COORDINATOR is set; the mesh then spans all processes' devices.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def data_mesh(n_devices: int = 0) -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))
