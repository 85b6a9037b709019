"""End-to-end smoke run of the diginorm engine on one GPU.

Drives the main path through ``cli.run`` (the same code as the
``normalise-kmers-tpu`` command) in this one process, on paired 2x150 FASTQ
generated from ``--seed``: ~1,000,000 pairs drawn from 20,000 transcripts of
500-3,000 bp with Zipf(1.0) abundance, 0.5 % substitution errors and 0.1 %
N. Phases, each printing one JSON line, every check exact:

  M  compiled memory of the k=15 direct and k=25 hashed steps
  K  the f32 keep rule at every (high, total) with total <= 1023, several -g
  A  k=15 -d 100 -g 0.9 paired exact, auto (direct table): the first 30,000
     pairs' decisions equal tests/oracle.py; processed = printed + skipped
  B  phase A with --table hashed: output files byte-identical to phase A's
  C  k=25 -c -d 200, auto (hashed), -m 1: the first 5,000 pairs equal the
     oracle and the table grows at least once
  D  k=15 --mode relaxed: final counts equal phase A's (compared on the
     device); k=15 --stride 2 runs to completion

``--four`` runs only the four-card paths: Mode B (``--sharding global``)
byte-identical to a one-card run, and Mode A's per-shard decisions over the
first three batches equal a sequential oracle at depth // 4 over the rows
each card was dealt.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
any failed check exits non-zero without it. The script needs a GPU; a CPU
rehearsal at toy sizes takes ``--tiny --cpu-rehearsal``.

    python chip_smoke.py
    python chip_smoke.py --four
    JAX_PLATFORMS=cpu python chip_smoke.py --tiny --cpu-rehearsal
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))  # the sequential oracle

READ_LEN = 150
BASES = np.frombuffer(b"ACGTN", np.uint8)

#: the reference-like deployment (FULL) and a CPU rehearsal size (TINY)
FULL = dict(pairs=1_000_000, transcripts=20_000, k_narrow=15,
            prefix_a=30_000, prefix_c=5_000, prefix_four=24_576,
            batch_pairs=8192)
TINY = dict(pairs=3_000, transcripts=20, k_narrow=11,
            prefix_a=600, prefix_c=300, prefix_four=768, batch_pairs=256)


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


# ----------------------------------------------------------------------
# input data
# ----------------------------------------------------------------------
def make_reads(seed: int, n_pairs: int, n_tx: int, chunk: int = 100_000):
    """Yields (first_pair_index, r1, r2) chunks of 2-bit+N codes (N = 4).

    Transcripts of 500-3,000 bp; each pair picks a transcript with Zipf(1.0)
    probability, a fragment of 200-500 bp, read 1 = the fragment's first
    150 bp, read 2 = the reverse complement of its last 150 bp; then 0.5 %
    substitutions (always to another base) and 0.1 % N per base."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(500, 3001, n_tx)
    tx = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    p = 1.0 / np.arange(1, n_tx + 1)
    p /= p.sum()
    idx = np.arange(READ_LEN)
    for lo in range(0, n_pairs, chunk):
        n = min(chunk, n_pairs - lo)
        t = rng.choice(n_tx, size=n, p=p)
        frag = np.minimum(rng.integers(200, 501, n), lens[t])
        start = offs[t] + (rng.random(n) * (lens[t] - frag + 1)).astype(np.int64)
        r1 = tx[start[:, None] + idx]
        r2 = 3 - tx[(start + frag - READ_LEN)[:, None] + idx][:, ::-1]
        for r in (r1, r2):
            sub = rng.random(r.shape, dtype=np.float32) < 0.005
            r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
            r[rng.random(r.shape, dtype=np.float32) < 0.001] = 4
        yield lo, r1, r2


def _fastq_block(first: int, reads: np.ndarray, mate: int) -> bytes:
    n = reads.shape[0]
    ids = np.arange(first, first + n, dtype=np.int64)
    digits = (ids[:, None] // 10 ** np.arange(6, -1, -1)) % 10 + 48
    hdr = np.empty((n, 12), np.uint8)
    hdr[:, 0], hdr[:, 1] = ord("@"), ord("p")
    hdr[:, 2:9] = digits
    hdr[:, 9], hdr[:, 10], hdr[:, 11] = ord("/"), ord(str(mate)), 10
    nl = np.full((n, 1), 10, np.uint8)
    plus = np.tile(np.frombuffer(b"+\n", np.uint8), (n, 1))
    qual = np.full((n, READ_LEN), ord("I"), np.uint8)
    return np.concatenate(
        [hdr, BASES[reads], nl, plus, qual, nl], axis=1).tobytes()


def write_inputs(seed: int, sz: dict, data_dir: str):
    """Writes r1.fastq / r2.fastq; returns them and the first pairs as
    strings (the oracle's prefix)."""
    os.makedirs(data_dir, exist_ok=True)
    f1, f2 = (os.path.join(data_dir, f"r{m}.fastq") for m in (1, 2))
    need = max(sz["prefix_a"], sz["prefix_c"], sz["prefix_four"])
    prefix = []
    with open(f1, "wb") as o1, open(f2, "wb") as o2:
        for lo, r1, r2 in make_reads(seed, sz["pairs"], sz["transcripts"]):
            o1.write(_fastq_block(lo, r1, 1))
            o2.write(_fastq_block(lo, r2, 2))
            for i in range(max(0, min(r1.shape[0], need - lo))):
                prefix.append((BASES[r1[i]].tobytes().decode(),
                               BASES[r2[i]].tobytes().decode()))
    return f1, f2, prefix


def printed_ids(path: str) -> set[int]:
    """Pair ids of the records in an output FASTQ (headers @pNNNNNNN/m)."""
    out = set()
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            if i % 4 == 0:
                out.add(int(line[2:9]))
    return out


def oracle_decisions(pairs, k: int, depth: int, coverage: float,
                     canonical: bool) -> list[bool]:
    from oracle import Oracle

    o = Oracle(k, depth, coverage, canonical)
    return [o.process_pair(a, b) for a, b in pairs]


# ----------------------------------------------------------------------
# measurement helpers
# ----------------------------------------------------------------------
class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (or loading from
    the persistent cache) while a phase runs."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event.startswith("/jax/core/compile/") or \
                event == "/jax/compilation_cache/cache_retrieval_time_sec":
            self.total += duration


def memory_fields() -> dict:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return {"peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_in_use": stats.get("bytes_in_use")}


def run_cli(argv, clock: CompileClock):
    """One CLI run in this process; returns (engine, timing fields)."""
    from nomalise_kmers_multi_large_tpu import cli

    c0, t0 = clock.total, time.perf_counter()
    rc, norm = cli.run(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli exit code {rc} for {argv}")
    compile_s = clock.total - c0
    rep = norm.report
    check(rep.total_processed == rep.total_printed + rep.total_skipped,
          "processed != printed + skipped")
    fields = {
        "wall_s": wall, "compile_s": compile_s,
        "reads_per_s_excl_compile": 2 * rep.total_processed
        / max(wall - compile_s, 1e-9),
        "processed": rep.total_processed, "printed": rep.total_printed,
        "skipped": rep.total_skipped, "max_unique_kmers": rep.max_total_kmers,
        "table": norm.cfg.table_kind, **memory_fields(),
    }
    return norm, fields


def outputs(out_dir: str) -> dict[str, bytes]:
    return {f: open(os.path.join(out_dir, f), "rb").read()
            for f in sorted(os.listdir(out_dir)) if f.startswith("output_")}


def base_argv(f1, f2, out_dir, sz, *extra):
    return ["-f", f1, "-r", f2, "--out-dir", out_dir,
            "--batch-reads", str(sz["batch_pairs"]), *extra]


def prefix_check(out_dir, k, depth, prefix, canonical, shard=0):
    """The first len(prefix) pairs' keep decisions equal the oracle's."""
    want = oracle_decisions(prefix, k, depth, 0.9, canonical)
    path = os.path.join(out_dir,
                        f"output_forward.k{k}_norm{depth}_thread{shard}.fastq")
    got_ids = printed_ids(path)
    got = [i in got_ids for i in range(len(prefix))]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(not bad, f"{len(bad)} of {len(prefix)} prefix decisions differ "
                   f"from the oracle (first: pair {bad[:5]})")
    return {"prefix_pairs": len(prefix), "prefix_kept": int(sum(want))}


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_memory(sz):
    """compiled.memory_analysis() of the k=15 direct and k=25 hashed steps
    at the CLI's batch shape (2 x batch pairs rows, 150 bp reads)."""
    import jax
    import jax.numpy as jnp

    from nomalise_kmers_multi_large_tpu.config import Config
    from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
    from nomalise_kmers_multi_large_tpu.table import make_table

    out = {}
    rows = 2 * sz["batch_pairs"]
    for k, extra in ((sz["k_narrow"], {}), (25, {"memory_gb": 1})):
        cfg = Config(forward_files=("f",), reverse_files=("r",), ksize=k,
                     **extra).validate()
        table = make_table(cfg)
        step = BatchStep(table, k=k, depth_per_shard=cfg.depth_per_shard,
                         coverage=cfg.coverage, canonical=False, paired=True)
        pad = ((READ_LEN + 1 - k + 7) // 8) * 8 + k - 1
        state = jax.eval_shape(table.init)
        args = (state, jax.ShapeDtypeStruct((rows, pad), jnp.uint8),
                jax.ShapeDtypeStruct((rows,), jnp.int32),
                jax.ShapeDtypeStruct((rows // 2,), jnp.bool_))
        ma = step._step.lower(*args).compile().memory_analysis()
        out[f"k{k}_{cfg.table_kind}"] = {
            name: getattr(ma, name, None) for name in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes")}
    return out


def phase_keep_rule():
    """The keep rule ratio = f32(high) / f32(total) < f32(coverage) on the
    device, at every total in 1..1023 (the reference's longest read) and
    every high in 0..total, equals the same f32 arithmetic done by numpy."""
    import jax
    import jax.numpy as jnp

    from nomalise_kmers_multi_large_tpu.models.diginorm import (
        keep_mask_paired, keep_mask_single,
    )

    total = np.repeat(np.arange(1, 1024), np.arange(2, 1025)).astype(np.int32)
    high = np.concatenate([np.arange(t + 1) for t in range(1, 1024)]
                          ).astype(np.int32)
    zeros = np.zeros_like(high)
    res = {"cases_per_coverage": int(high.size)}
    for cov in (0.9, 0.5, 0.75, 0.1, 1.0, 1 / 3, 0.99, 0.001):
        want = (high.astype(np.float32) / total.astype(np.float32)
                ) < np.float32(cov)
        single = jax.jit(lambda h, t, c=cov: keep_mask_single(h, t, c))
        paired = jax.jit(lambda h, t, z, c=cov: keep_mask_paired(
            h, t, z, t, c))
        got_s = np.asarray(single(jnp.asarray(high), jnp.asarray(total)))
        got_p = np.asarray(paired(jnp.asarray(high), jnp.asarray(total),
                                  jnp.asarray(zeros)))
        bad = int((got_s != want).sum() + (got_p != want).sum())
        check(bad == 0, f"keep rule differs from f32 numpy at -g {cov}: "
                        f"{bad} cases")
        # what the device's own f32 divide would decide (why the rule is a
        # host-built table): reported, not required
        divide = jax.jit(lambda h, t, c=cov: (
            h.astype(jnp.float32) / t.astype(jnp.float32)) < jnp.float32(c))
        raw = np.asarray(divide(jnp.asarray(high), jnp.asarray(total)))
        res[f"device_divide_mismatches_g{cov:.6g}"] = int((raw != want).sum())
        res[f"boundary_cases_g{cov:.6g}"] = int(
            (high.astype(np.float64) / total == np.float32(cov)).sum())
    return res


def run_phase(res: dict, name: str, fn) -> bool:
    """Run one phase, print its JSON line and record it in ``res``. A
    failure is printed and recorded (the script then exits non-zero)."""
    t0 = time.perf_counter()
    try:
        line = fn()
        line["ok"] = True
    except Exception as e:
        traceback.print_exc()
        line = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    line["phase"], line["phase_s"] = name, time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    res[name] = line
    gc.collect()
    return line["ok"]


def main_phases(args, sz, f1, f2, prefix, work, clock):
    import jax.numpy as jnp

    kn = sz["k_narrow"]
    res = {}

    def out(name):
        d = os.path.join(work, name)
        shutil.rmtree(d, ignore_errors=True)
        return d

    def record(name, fn):
        return run_phase(res, name, fn)

    record("M memory_analysis", lambda: phase_memory(sz))
    record("K keep rule", phase_keep_rule)

    keep = {}

    def phase_a():
        norm, f = run_cli(base_argv(f1, f2, out("A"), sz, "-k", str(kn),
                                    "-d", "100", "-g", "0.9"), clock)
        check(norm.cfg.table_kind == "direct", "auto did not pick direct")
        keep["counts"] = norm.states[0].counts
        f["table_grew"] = False
        f.update(prefix_check(os.path.join(work, "A"), kn, 100,
                              prefix[:sz["prefix_a"]], False))
        return f

    a_ok = record("A k15 exact direct", phase_a)

    def phase_b():
        check(a_ok, "phase A failed")
        norm, f = run_cli(base_argv(f1, f2, out("B"), sz, "-k", str(kn),
                                    "-d", "100", "-g", "0.9",
                                    "--table", "hashed"), clock)
        f["table_grew"] = norm.tables[0].capacity > norm.cfg.initial_hash_capacity
        check(int(norm.states[0].overflow) == 0, "hashed table dropped inserts")
        a, b = outputs(os.path.join(work, "A")), outputs(os.path.join(work, "B"))
        check(sorted(a) == sorted(b) and len(a) >= 2, f"output sets {a} {b}")
        diff = [n for n in a if a[n] != b[n]]
        check(not diff, f"direct and hashed outputs differ: {diff}")
        f["outputs_identical_to_A"] = sorted(a)
        return f

    record("B k15 exact hashed", phase_b)

    def phase_c():
        norm, f = run_cli(base_argv(f1, f2, out("C"), sz, "-k", "25", "-c",
                                    "-d", "200", "-m", "1"), clock)
        check(norm.cfg.table_kind == "hashed", "auto did not pick hashed")
        start = norm.cfg.initial_hash_capacity
        f["table_capacity_start"] = start
        f["table_capacity_end"] = norm.tables[0].capacity
        f["table_grew"] = norm.tables[0].capacity > start
        check(int(norm.states[0].overflow) == 0, "hashed table dropped inserts")
        if not args.tiny:
            check(f["table_grew"], "the k=25 table never grew")
        f.update(prefix_check(os.path.join(work, "C"), 25, 200,
                              prefix[:sz["prefix_c"]], True))
        return f

    record("C k25 canonical hashed", phase_c)

    def phase_d_relaxed():
        check(a_ok, "phase A failed")
        norm, f = run_cli(base_argv(f1, f2, out("D1"), sz, "-k", str(kn),
                                    "-d", "100", "-g", "0.9",
                                    "--mode", "relaxed"), clock)
        same = bool(jnp.array_equal(norm.states[0].counts, keep["counts"]))
        check(same, "relaxed-mode counts differ from exact-mode counts")
        f["counts_equal_A"] = same
        f["table_grew"] = False
        return f

    record("D relaxed counts", phase_d_relaxed)
    keep.clear()

    def phase_d_stride():
        norm, f = run_cli(base_argv(f1, f2, out("D2"), sz, "-k", str(kn),
                                    "-d", "100", "-g", "0.9",
                                    "--stride", "2"), clock)
        check(f["processed"] == sz["pairs"], "stride run lost records")
        f["table_grew"] = False
        return f

    record("D stride 2", phase_d_stride)
    return res


def four_phases(args, sz, f1, f2, prefix, work, clock):
    """Mode B vs one card (byte for byte); Mode A vs per-shard oracles."""
    import jax

    kn = sz["k_narrow"]
    res = {}

    def spread(arr) -> list[int]:
        """Bytes of ``arr`` held on each device of its sharding."""
        per = {}
        for s in arr.addressable_shards:
            per[s.device.id] = per.get(s.device.id, 0) + s.data.nbytes
        return [per.get(d.id, 0) for d in jax.devices()]

    def record(name, fn):
        return run_phase(res, name, fn)

    def mode_b():
        d1, d4 = os.path.join(work, "one"), os.path.join(work, "modeB")
        common = ["-k", str(kn), "-d", "100", "-g", "0.9"]
        one, f1card = run_cli(base_argv(f1, f2, d1, sz, *common,
                                        "--devices", "1"), clock)
        del one  # free device 0's table before the mesh run
        gc.collect()
        norm, f = run_cli(base_argv(f1, f2, d4, sz, *common, "--devices", "4",
                                    "--sharding", "global"), clock)
        bytes_per_dev = spread(norm._global_state.counts)
        check(sum(b > 0 for b in bytes_per_dev) == 4,
              f"Mode B table not on 4 devices: {bytes_per_dev}")
        a, b = outputs(d1), outputs(d4)
        check(sorted(a) == sorted(b) and a, f"output sets {list(a)} {list(b)}")
        diff = [n for n in a if a[n] != b[n]]
        check(not diff, f"Mode B outputs differ from one card: {diff}")
        f["one_card"] = f1card
        f["table_bytes_per_device"] = bytes_per_dev
        f["outputs_identical_to_one_card"] = sorted(a)
        return f

    def mode_a():
        d = os.path.join(work, "modeA")
        norm, f = run_cli(base_argv(f1, f2, d, sz, "-k", str(kn), "-d", "100",
                                    "-g", "0.9", "--devices", "4"), clock)
        bytes_per_dev = spread(norm._stacked.counts)
        check(sum(b > 0 for b in bytes_per_dev) == 4,
              f"Mode A tables not on 4 devices: {bytes_per_dev}")
        # parallel/engine.py deals each batch of B pairs in contiguous
        # slices of ceil(B / 4): shard s takes pairs [s*per, (s+1)*per) of
        # every batch, so its stream is those slices in batch order
        B = sz["batch_pairs"]
        per = -(-B // 4)
        n_batches = min(len(prefix), sz["pairs"]) // B
        check(n_batches >= 1, "oracle prefix shorter than one batch")
        depth = 100 // 4
        f["per_shard"] = []
        for s in range(4):
            rows = [b * B + i for b in range(n_batches)
                    for i in range(s * per, min((s + 1) * per, B))]
            want = oracle_decisions([prefix[i] for i in rows], kn, depth,
                                    0.9, False)
            got_ids = printed_ids(os.path.join(
                d, f"output_forward.k{kn}_norm{depth}_thread{s}.fastq"))
            bad = [i for i, w in zip(rows, want) if (i in got_ids) != w]
            check(not bad, f"shard {s}: {len(bad)} decisions differ from "
                           f"the oracle (first: pair {bad[:5]})")
            f["per_shard"].append({"pairs": len(rows), "kept": int(sum(want))})
        f["table_bytes_per_device"] = bytes_per_dev
        return f

    record("4B Mode B vs one card", mode_b)
    record("4A Mode A vs per-shard oracle", mode_a)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="input data seed")
    ap.add_argument("--four", action="store_true",
                    help="only the four-card Mode A / Mode B checks")
    ap.add_argument("--tiny", action="store_true",
                    help="toy sizes (for a rehearsal)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="allow a run without a GPU (with --tiny)")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not (args.cpu_rehearsal and args.tiny):
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if args.four and jax.device_count() < 4:
        print(f"--four needs 4 devices; JAX found {jax.device_count()}",
              file=sys.stderr)
        return 2

    from nomalise_kmers_multi_large_tpu.io import native
    from nomalise_kmers_multi_large_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from nomalise_kmers_multi_large_tpu.utils.devinfo import (
        device_fields, nvidia_smi_line,
    )

    cache = enable_compile_cache()
    sz = TINY if args.tiny else FULL
    print(json.dumps({"device": device_fields(), "jax": jax.__version__,
                      "native_io_loaded": native.get_lib() is not None,
                      "compile_cache": cache, "sizes": sz}), flush=True)

    clock = CompileClock()
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        f1, f2, prefix = write_inputs(args.seed, sz, os.path.join(work, "data"))
        print(json.dumps({"phase": "inputs", "pairs": sz["pairs"],
                          "bytes": os.path.getsize(f1) + os.path.getsize(f2),
                          "phase_s": time.perf_counter() - t0}), flush=True)
        phases = four_phases if args.four else main_phases
        res = phases(args, sz, f1, f2, prefix, work, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failed = [name for name, line in res.items() if not line["ok"]]
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    fields = device_fields()
    if fields["count"] < want:
        return 1
    print(nvidia_smi_line())  # card name and power limit, as nvidia-smi says
    print(json.dumps({"ok": True, "device": fields}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
