"""Checkpoint / resume.

The reference has no checkpointing — its closest artifacts are the -P k-mer TSV
dump (print_kmer_table, normalise_kmers_multi_large.c:354-385) and a TODO to
accept a k-mer TSV as a seed for a future run (:74-77). This module delivers
both: periodic snapshots of (table state, stream position, counters, output file
sizes) enabling exact resume, and TSV-seeded startup (see cli --seed-table).

Snapshot layout (checkpoint_dir/):
  manifest.json     config fingerprint + stream position + counters + file sizes
  shard{N}.npz      table arrays of shard N
Written atomically (tmp + rename) so a crash mid-save keeps the previous one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import jax.numpy as jnp
import numpy as np


def _fingerprint(cfg) -> dict:
    return {
        "forward_files": list(cfg.forward_files),
        "reverse_files": list(cfg.reverse_files),
        "ksize": cfg.ksize,
        "depth": cfg.depth,
        "coverage": cfg.coverage,
        "canonical": cfg.canonical,
        "shards": cfg.shards,
        "mode": cfg.mode,
        "stride": cfg.stride,
        "table": cfg.table_kind,
        "single": cfg.single,
        "informat": cfg.informat,
        "outformat": cfg.outformat,
        "pair_rule": cfg.pair_rule,
    }


@dataclasses.dataclass
class ResumePoint:
    file_index: int
    records_done: int          # records consumed of the current file (pair)
    counters: list[dict]       # per-shard processed/printed/skipped
    output_sizes: dict         # path -> byte size at snapshot
    rr: int                    # round-robin cursor
    seeded_lo: Optional[np.ndarray]
    shadows: Optional[list] = None  # per-shard debug>2 shadow counts


class CheckpointManager:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dir = cfg.checkpoint_dir

    def _manifest_path(self):
        return os.path.join(self.dir, "manifest.json")

    # ------------------------------------------------------------------
    def save(self, states, counters, file_index: int, records_done: int,
             output_paths: list[str], rr: int, seeded_lo=None,
             shadows=None):
        os.makedirs(self.dir, exist_ok=True)
        if shadows is not None:
            # --debug>2 host shadow tables ride the snapshot so upsert
            # counts stay ABSOLUTE across a resume (round-4 advisor item)
            for s, sh in enumerate(shadows):
                codes = np.fromiter(sh.counts.keys(), np.uint64,
                                    len(sh.counts))
                vals = np.fromiter(sh.counts.values(), np.int64,
                                   len(sh.counts))
                fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npz.tmp")
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, codes=codes, vals=vals)
                os.replace(tmp, os.path.join(self.dir, f"shadow{s}.npz"))
        for s, state in enumerate(states):
            arrays = {"counts": np.asarray(state.counts),
                      "used": np.asarray(state.used),
                      "overflow": np.asarray(state.overflow)}
            if state.keys is not None:
                arrays["keys"] = np.asarray(state.keys)
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, os.path.join(self.dir, f"shard{s}.npz"))
        if seeded_lo is not None:
            np.save(os.path.join(self.dir, "seeded_lo.npy"), seeded_lo)
        manifest = {
            "config": _fingerprint(self.cfg),
            "file_index": file_index,
            "records_done": records_done,
            "counters": [
                {"processed": c.processed, "printed": c.printed,
                 "skipped": c.skipped, "unique_kmers": c.unique_kmers}
                for c in counters
            ],
            "output_sizes": {
                p: (os.path.getsize(p) if os.path.exists(p) else 0)
                for p in output_paths
            },
            "rr": rr,
        }
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, self._manifest_path())

    # ------------------------------------------------------------------
    def load(self) -> Optional[tuple[list, ResumePoint]]:
        """Returns (states, ResumePoint) or None if no checkpoint exists."""
        if not os.path.exists(self._manifest_path()):
            return None
        with open(self._manifest_path()) as f:
            manifest = json.load(f)
        want = _fingerprint(self.cfg)
        if manifest["config"] != want:
            raise ValueError(
                "checkpoint config mismatch: "
                f"saved {manifest['config']} vs current {want}"
            )
        from nomalise_kmers_multi_large_tpu.table.base import TableState

        states = []
        for s in range(self.cfg.shards):
            z = np.load(os.path.join(self.dir, f"shard{s}.npz"))
            states.append(
                TableState(
                    counts=jnp.asarray(z["counts"]),
                    keys=jnp.asarray(z["keys"]) if "keys" in z else None,
                    used=jnp.asarray(z["used"]),
                    overflow=jnp.asarray(z["overflow"]),
                )
            )
        seeded = None
        seed_path = os.path.join(self.dir, "seeded_lo.npy")
        if os.path.exists(seed_path):
            seeded = np.load(seed_path)
        shadows = None
        if os.path.exists(os.path.join(self.dir, "shadow0.npz")):
            shadows = []
            for s in range(self.cfg.shards):
                z = np.load(os.path.join(self.dir, f"shadow{s}.npz"))
                shadows.append(dict(zip(z["codes"].tolist(),
                                        z["vals"].tolist())))
        rp = ResumePoint(
            file_index=manifest["file_index"],
            records_done=manifest["records_done"],
            counters=manifest["counters"],
            output_sizes=manifest["output_sizes"],
            rr=manifest.get("rr", 0),
            seeded_lo=seeded,
            shadows=shadows,
        )
        return states, rp
