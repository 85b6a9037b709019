"""Run configuration.

Mirrors the reference's global ``struct config_t cfg`` and its validation rules
(normalise_kmers_multi_large.c:208-231, parse_arguments :520-745), plus the
device engine's extensions (batch size, semantics mode, table kind, device mesh
shape).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

#: reference INITIAL_CAPACITY (normalise_kmers_multi_large.c:137): prime just above
#: 1 GB worth of 16-byte slots. We keep the same default *slot count* so default
#: memory behaviour is comparable.
INITIAL_CAPACITY = 67_108_879
MAX_K = 31
MIN_K = 5
MAX_SHARDS = 256  # reference MAX_THREADS (normalise_kmers_multi_large.c:142)
SEED_NUMBER = 3_000_000  # reference SEED_NUMBER (:146)
REPORTING_INTERVAL = 60.0  # seconds (:145)
BYTES_PER_SLOT = 16  # reference kmer_t size; used for the --memory_start contract


class ConfigError(ValueError):
    """Invalid configuration (reference exits with the analogous stderr message)."""


def _normalize_format(fmt: str, what: str) -> str:
    f = fmt.lower()
    if f in ("fa", "fasta", "fsa", "fas"):
        return "fa"
    if f in ("fq", "fastq", "fsq"):
        return "fq"
    raise ConfigError(f"{what} file format must be either fa or fq, not {fmt}")


@dataclasses.dataclass(frozen=True)
class Config:
    """Everything a run needs. Frozen so it can be closed over by jitted functions."""

    # --- reference flags (normalise_kmers_multi_large.c:543-560) ---
    forward_files: tuple[str, ...] = ()
    reverse_files: tuple[str, ...] = ()
    ksize: int = 15                      # --ksize|-k
    depth: int = 100                     # --depth|-d
    coverage: float = 0.9                # --coverage|-g
    canonical: bool = False              # --canonical|-c
    informat: str = "fq"                 # --filetype|-t
    outformat: str = "fq"                # --outformat|-o
    shards: int = 1                      # --cpu|-p : reference threads -> table shards
    memory_gb: int = 0                   # --memory_start|-m (0 => INITIAL_CAPACITY)
    verbose: bool = False                # --verbose|-e
    debug: int = 0                       # --debug|-b
    single: bool = False                 # --single|-s
    print_table: bool = False            # --print|-P

    # --- device engine extensions ---
    out_dir: str = "."
    batch_reads: int = 8192              # reads (or pairs) per device batch
    mode: Literal["exact", "relaxed"] = "exact"
    #: 'direct' = dense 4^k count array (exact reference semantics, k<=15);
    #: 'hashed' = open-addressing device table with growth; 'auto' picks.
    table: Literal["auto", "direct", "hashed"] = "auto"
    max_read_len: int = 1023             # reference MAX_LINE_LENGTH-1 (:139)
    pad_read_len: int = 0                # 0 => derived from data (window count
                                         # rounded up to a multiple of 8)
    seed_records: int = 0                # 0 => reference formula 1 + 3e6/n_fwd_files
    seed_table: str = ""                 # k-mer TSV to use as the seed set, the
                                         # reference's planned feature (nk.c:74-77)
    checkpoint_every: int = 0            # batches; 0 => no checkpointing
    checkpoint_dir: str = ".checkpoints"
    resume: bool = False
    pair_rule: Literal["and", "avg"] = "and"   # reference keeps 'and' (:1646); 'avg'
                                               # is its commented-out alternative (:1638)
    stride: int = 1                      # sample every s-th window; 1 = reference
                                         # semantics; >1 per nk.c:30-33's own TODO
    dispatch_group: int = 1              # batches per device dispatch (lax.scan
                                         # grouping, engine/step.py
                                         # step_many). 1 = one batch per call.
    prefetch: int = 2                    # host frame+pack batches prepared
                                         # ahead on a worker thread
                                         # (utils/prefetch.py); 0 = inline
    io_threads: int = 0                  # native frame/pack pthread pool
                                         # width (io/_fastx.c); 0 = all
                                         # cores (NKMT_IO_THREADS overrides)
    n_devices: int = 0                   # 0 => all local devices
    sharding: Literal["local", "global"] = "local"  # Mode A vs Mode B
    spectrum: bool = False               # print k-mer spectrum stats at the end
                                         # (the reference's wished-for histogram,
                                         # nk.c:85-90)
    profile_dir: str = ""                # write a jax.profiler device trace here

    # ------------------------------------------------------------------
    @property
    def depth_per_shard(self) -> int:
        """Reference depth_per_cpu = depth / cpus, INTEGER division (:674).

        The effective high-coverage threshold depends on shard count, and output
        filenames embed this value (``norm{depth_per_cpu}``, :2286).
        """
        return self.depth // self.shards

    @property
    def is_input_fastq(self) -> bool:
        return _normalize_format(self.informat, "Input") == "fq"

    @property
    def is_output_fastq(self) -> bool:
        return _normalize_format(self.outformat, "Output") == "fq"

    @property
    def lines_per_record(self) -> int:
        return 4 if self.is_input_fastq else 2

    @property
    def records_to_seed(self) -> int:
        """Reference: 1 + SEED_NUMBER / forward_file_count (main :2242)."""
        if self.seed_records > 0:
            return self.seed_records
        n = max(1, len(self.forward_files))
        return 1 + int(SEED_NUMBER / n)

    @property
    def table_kind(self) -> str:
        """'auto' resolves to the dense direct table while 4^k int32 slots
        fit (k <= 15, 4 GiB at k = 15) and to the hashed table above."""
        if self.table != "auto":
            return self.table
        return "direct" if self.ksize <= 15 else "hashed"

    @property
    def direct_capacity(self) -> int:
        return 4 ** self.ksize

    @property
    def initial_hash_capacity(self) -> int:
        """Initial hashed-table capacity per shard.

        The reference converts --memory_start GB across cpus at 16 B/slot and clamps
        to 4^k (parse_arguments :676-684). We keep that contract but round up to a
        power of two so the probe sequence can use a mask instead of a modulo.
        """
        if self.memory_gb > 0:
            slots = int(self.memory_gb * (1 << 30) / BYTES_PER_SLOT / self.shards)
        else:
            slots = INITIAL_CAPACITY
        slots = min(slots, 4 ** self.ksize)
        return 1 << max(10, math.ceil(math.log2(max(2, slots))))

    # ------------------------------------------------------------------
    def validate(self) -> "Config":
        """Reference validation rules, same order/meaning (:704-743)."""
        _normalize_format(self.informat, "Input")
        _normalize_format(self.outformat, "Output")
        if self.memory_gb < 0:
            raise ConfigError(f"Memory cannot be less than 1 Gb {self.memory_gb}")
        if not self.forward_files or (not self.reverse_files and not self.single):
            raise ConfigError(
                f"no fwd ({len(self.forward_files)}) or reverse "
                f"({len(self.reverse_files)}) files provided"
            )
        if not self.is_input_fastq and self.is_output_fastq:
            raise ConfigError("cannot request an output format of FASTQ when input is FASTA")
        if not self.single and len(self.forward_files) != len(self.reverse_files):
            raise ConfigError(
                f"Number of forward ({len(self.forward_files)}) and reverse files "
                f"({len(self.reverse_files)}) must match"
            )
        if self.shards <= 0 or self.shards > MAX_SHARDS:
            raise ConfigError(
                f"CPU count ({self.shards}) must be a positive integer and up to {MAX_SHARDS}"
            )
        if self.ksize < MIN_K or self.ksize > MAX_K:
            raise ConfigError(f"Only kmer sizes ({self.ksize}) of 5 to 31 are supported")
        if self.coverage > 1 or self.coverage < 0.001:
            raise ConfigError(
                f"Coverage ({self.coverage}) is the proportion of the sequence covered "
                "by high kmers and must be between 0 and 1"
            )
        if self.depth < 2:
            raise ConfigError(
                f"Depth ({self.depth}) is the number of times a kmer needs to be found "
                "before being flagged as high coverage, it must be above 1"
            )
        if self.depth_per_shard < 2:
            raise ConfigError(
                f"Depth ({self.depth}) must be at least 2 x number of CPUs"
            )
        if self.mode not in ("exact", "relaxed"):
            raise ConfigError(f"mode must be exact or relaxed, not {self.mode}")
        if self.table not in ("auto", "direct", "hashed"):
            raise ConfigError(
                f"table must be auto, direct or hashed, not {self.table}"
            )
        if self.table == "direct" and self.ksize > 15:
            raise ConfigError("direct table supports k<=15 (4^k int32 slots); use hashed")
        if self.batch_reads < 1:
            raise ConfigError(f"batch-reads ({self.batch_reads}) must be >= 1")
        if self.stride < 1 or self.stride > self.ksize:
            raise ConfigError(f"stride ({self.stride}) must be in [1, k]")
        if self.dispatch_group < 1:
            raise ConfigError(
                f"dispatch-group ({self.dispatch_group}) must be >= 1")
        if self.prefetch < 0:
            raise ConfigError(f"prefetch ({self.prefetch}) must be >= 0")
        return self
