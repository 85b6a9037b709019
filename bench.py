"""Benchmark lines of the diginorm engine, one JSON object per line.

Device lines (jitted ``BatchStep.step_many`` on tables from ``make_table``,
inputs staged on the device):
  k=15 exact, k=15 relaxed, k=15 --stride 2 (direct table), k=21 and k=31
  (hashed table).
End-to-end line: generated FASTQ pairs through the real ``Normalizer``
(mmap -> frame -> pack -> dispatch -> write) with the engine's host stage
breakdown; file pair 1 pays compilation and seeding, file pair 2 is the
steady state.
Host line: the native frame+pack rate (io/_fastx.c), no device.

Every line names the JAX device (platform, device_kind, count) and the card's
``nvidia-smi`` name and power limit. The measurement needs a GPU: with no GPU
the script exits non-zero before measuring anything. ``--tiny`` is a CPU
rehearsal at toy sizes (its numbers are not device measurements). A line
that fails makes the script exit non-zero after the remaining lines ran.

    python bench.py            # on the card
    python bench.py --trace build/trace   # per-op-group device time
    JAX_PLATFORMS=cpu python bench.py --tiny
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

import numpy as np

READ_LEN = 150
K = 15
BASELINE_READS_PER_S = 2 * 121_614  # reference 10-CPU aggregate (README.md:78)
HERE = os.path.dirname(os.path.abspath(__file__))

#: (batch rows, batches per dispatch, timed dispatches per round, rounds,
#: e2e pairs); batch rows = 2 x the CLI's default --batch-reads of 8192 pairs
FULL = dict(rows=16384, group=4, iters=4, rounds=3, e2e_pairs=300_000)
TINY = dict(rows=64, group=2, iters=1, rounds=1, e2e_pairs=512)


def _stamp() -> dict:
    from nomalise_kmers_multi_large_tpu.utils.devinfo import (
        device_fields, nvidia_smi_line,
    )

    return {"device": device_fields(), "gpu": nvidia_smi_line()}


def _emit(line: dict, tiny: bool):
    line.update(_stamp())
    if tiny:
        line["rehearsal"] = "cpu --tiny: not a device measurement"
    print(json.dumps(line), flush=True)


def _config(k: int, **kw):
    from nomalise_kmers_multi_large_tpu.config import Config

    return Config(forward_files=("bench_f.fastq",),
                  reverse_files=("bench_r.fastq",), ksize=k, **kw).validate()


def _device_rate(sz: dict, k: int, mode: str = "exact", stride: int = 1):
    """reads/s of grouped device steps on the table ``make_table`` picks."""
    import jax
    import jax.numpy as jnp

    from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
    from nomalise_kmers_multi_large_tpu.table import make_table

    cfg = _config(k, depth=50, mode=mode, stride=stride)
    table = make_table(cfg)
    pad = READ_LEN + (k - K)  # 136 windows per read at every k
    rows, group = sz["rows"], sz["group"]
    rng = np.random.default_rng(0)
    # duplication structure: reads drawn from a 4,096-read pool
    pool = rng.integers(0, 4, size=(4096, pad), dtype=np.uint8)
    idx = rng.integers(0, pool.shape[0], size=(group, rows))
    bases = jnp.asarray(pool[idx])
    lengths = jnp.asarray(np.full((group, rows), pad, np.int32))
    valid = jnp.asarray(np.ones((group, rows // 2), bool))
    step = BatchStep(table, k=k, depth_per_shard=cfg.depth_per_shard,
                     coverage=cfg.coverage, canonical=False, paired=True,
                     mode=mode, stride=stride)
    state = table.init()
    t0 = time.perf_counter()
    for _ in range(2):  # compile + warm
        state, keep, _, _ = step.step_many(state, bases, lengths, valid)
    jax.block_until_ready((state, keep))
    warm_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(sz["rounds"]):
        t0 = time.perf_counter()
        for _ in range(sz["iters"]):
            state, keep, _, _ = step.step_many(state, bases, lengths, valid)
        jax.block_until_ready((state, keep))
        best = min(best, time.perf_counter() - t0)
    return {
        "value": rows * group * sz["iters"] / best,
        "table": cfg.table_kind,
        "batch_rows": rows, "dispatch_group": group,
        "compile_and_warmup_s": warm_s,
    }


DEVICE_LINES = [
    ("k=15 paired exact", dict(k=15)),
    ("k=15 paired relaxed", dict(k=15, mode="relaxed")),
    ("k=15 paired exact --stride 2", dict(k=15, stride=2)),
    ("k=21 paired exact", dict(k=21)),
    ("k=31 paired exact", dict(k=31)),
]


def device_line(sz: dict, tiny: bool, name: str, kw: dict):
    got = _device_rate(sz, **kw)
    line = {"metric": f"reads/s device count+filter ({name}, "
                      f"{got['table']} table)",
            "unit": "reads/s", **got}
    if kw == {"k": 15}:
        line["vs_baseline"] = got["value"] / BASELINE_READS_PER_S
    _emit(line, tiny)


def _write_fastq(path, seqs):
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                         for i, s in enumerate(seqs)))


def e2e_line(sz: dict, tiny: bool):
    """Real files through the real engine on a workload that crosses depth:
    a pool of 1,024 reads at depth 25 skips most reads once counts build."""
    import contextlib
    import io

    from nomalise_kmers_multi_large_tpu.engine.pipeline import Normalizer

    rng = np.random.default_rng(1)
    pool = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=(1024, READ_LEN))]
    work = os.path.join(HERE, "build", "bench_e2e")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "out"))
    try:
        pairs_per_group = (sz["rows"] // 2) * sz["group"]
        n_main = max(1, round(sz["e2e_pairs"] / pairs_per_group)) \
            * pairs_per_group
        files = {}
        for tag, n in (("w", 3 * pairs_per_group), ("m", n_main)):
            for mate in ("f", "r"):
                p = os.path.join(work, f"{mate}{tag}.fastq")
                _write_fastq(p, [pool[j].tobytes()
                                 for j in rng.integers(0, len(pool), n)])
                files[mate + tag] = p
        nbytes = os.path.getsize(files["fm"]) + os.path.getsize(files["rm"])
        cfg = _config(K, depth=25, batch_reads=sz["rows"] // 2,
                      dispatch_group=sz["group"], seed_records=pairs_per_group,
                      out_dir=os.path.join(work, "out"))
        import dataclasses

        cfg = dataclasses.replace(
            cfg, forward_files=(files["fw"], files["fm"]),
            reverse_files=(files["rw"], files["rm"]))
        norm = Normalizer(cfg)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = norm.run()
        wall = time.perf_counter() - t0
        stages = dict(norm.timer.totals)
        steady = norm.file_walls[1]
        # "pack" runs on the prefetch worker, overlapped with device time;
        # the main thread's exposure to ingest is "produce_wait"
        main_ms = {n: v * 1e3 for n, v in stages.items() if n != "pack"}
        _emit({
            "metric": "reads/s end-to-end steady state (FASTQ -> filtered "
                      "FASTQ, k=15 paired depth 25; file pair 2 of one run)",
            "unit": "reads/s",
            "value": 2 * n_main / steady,
            "input_mb": nbytes / 1e6,
            "processed": report.total_processed,
            "printed": report.total_printed,
            "skipped": report.total_skipped,
            "total_wall_s": wall,
            "file_walls_s": norm.file_walls,
            "stage_ms": dict(sorted(main_ms.items(), key=lambda kv: -kv[1])),
            "overlapped_worker_ms": {"pack": stages.get("pack", 0.0) * 1e3},
        }, tiny)

        from nomalise_kmers_multi_large_tpu.io import native
        from nomalise_kmers_multi_large_tpu.io.pack import pack_batch
        from nomalise_kmers_multi_large_tpu.io.reader import (
            FastxFile, batch_iterator,
        )

        fx = FastxFile(files["fm"], fastq=True)

        def sweep():
            n_rec = 0
            for rb in batch_iterator(fx, sz["rows"]):
                _, lengths_h = pack_batch(
                    fx.data, rb.fwd.seq_start, rb.fwd.seq_len, READ_LEN, K)
                n_rec += lengths_h.shape[0]
            return n_rec

        n_rec = sweep()  # warm the page cache
        best = float("inf")
        for _ in range(6):
            t0 = time.perf_counter()
            sweep()
            best = min(best, time.perf_counter() - t0)
        _emit({
            "metric": "host mmap+frame+pack rate (io/_fastx.c, "
                      f"{native.default_threads()} threads on "
                      f"{os.cpu_count()} cores, native="
                      f"{native.get_lib() is not None})",
            "unit": "GB/s",
            "value": os.path.getsize(files["fm"]) / best / 1e9,
            "reads_per_s": n_rec / best,
        }, tiny)
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: named scopes of the batch step (engine/step.py, ops/streamrank.py,
#: table/hashed.py), innermost first: the op group a kernel is charged to
SCOPES = ("probe", "sort", "segments", "relaxed_ranks", "unsort", "table",
          "encode", "classify")


def _scope_map(hlo_text: str) -> dict:
    """HLO instruction name -> op group, from each instruction's op_name
    metadata (both the HLO spelling and the kernel spelling with '_')."""
    import re

    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"',
                     re.M)
    for name, op_name in pat.findall(hlo_text):
        parts = set(op_name.split("/"))
        scope = next((sc for sc in SCOPES if sc in parts), "other")
        out[name] = scope
        out[name.replace(".", "_").replace("-", "_")] = scope
    return out


def _lookup_scope(scope_of: dict, kernel: str) -> str:
    """Op group of a GPU kernel event. Kernels carry the name of the HLO
    instruction they were emitted for, spelt with '_' for '.', with a launch
    suffix for repeated launches ('sort_16_1__20' for instruction 'sort.16')."""
    import re

    name = re.sub(r"__\d+$", "", kernel)
    for cand in (kernel, name, re.sub(r"_\d+$", "", name)):
        if cand in scope_of:
            return scope_of[cand]
    return "other"


def reduce_trace(trace_dir: str, hlo_text: str, n_steps: int) -> dict:
    """Per-step device time of each op group, device busy share over the
    traced window, and the heaviest kernels, from a jax.profiler trace."""
    import glob

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    pd = ProfileData.from_file(sorted(paths)[-1])
    scope_of = _scope_map(hlo_text)
    layout, events = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        names = [ln.name for ln in lines]
        layout[plane.name] = names
        # kernel-level lines: "XLA Ops" when the trace has it, else streams
        use = [ln for ln in lines if ln.name == "XLA Ops"] or \
            [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in use:
            for ev in ln.events:
                stats = {}
                for kv in ev.stats:
                    try:
                        stats[str(kv[0])] = kv[1]
                    except (TypeError, IndexError):
                        pass
                # kernels inside a CUDA graph carry hlo_op "command_buffer";
                # their own name still names the HLO instruction
                events.append((ev.start_ns, ev.duration_ns,
                               str(stats.get("hlo_op", "")), ev.name))
    if not events:
        return {"device_planes": layout, "error": "no device kernel events"}
    events.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for st, du, _, _ in events:
        en = st + du
        if cur_e is None or st > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = max(st + du for st, du, _, _ in events) - events[0][0]
    groups, kernels = {}, {}
    for _, du, op, name in events:
        sc = _lookup_scope(scope_of, name)
        if sc == "other":
            sc = _lookup_scope(scope_of, op)
        groups[sc] = groups.get(sc, 0.0) + du
        key = (name, sc)
        kernels[key] = kernels.get(key, 0.0) + du
    per = 1e6 * n_steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": n_steps,
        "window_ms_per_step": window / per,
        "busy_ms_per_step": busy / per,
        "idle_share": 1 - busy / window,
        "group_ms_per_step": {g: v / per for g, v in
                              sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n, sc, v / per] for (n, sc), v in top],
        "device_planes": layout,
    }


def trace_lines(sz: dict, tiny: bool, out_dir: str, n_steps: int = 5):
    """Trace steady single-batch steps (the CLI's default dispatch) at k=15
    (direct table) and k=25 (hashed table), on inputs drawn like the
    chip_smoke data; write the trace and the step's HLO under out_dir and
    print the per-group reduction."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import make_reads
    from nomalise_kmers_multi_large_tpu.engine.step import BatchStep
    from nomalise_kmers_multi_large_tpu.table import make_table

    rows = sz["rows"]
    n_pairs = (n_steps + 4) * rows // 2
    _, r1, r2 = next(make_reads(0, n_pairs, 20_000 if not tiny else 20,
                                chunk=n_pairs))
    reads = np.empty((2 * n_pairs, READ_LEN), np.uint8)
    reads[0::2], reads[1::2] = r1, r2
    reads = np.where(reads == 4, 0, reads).astype(np.uint8)  # N -> A
    for k, extra in ((K, {}), (25, {"canonical": True})):
        cfg = _config(k, depth=100 if k == K else 200, **extra)
        table = make_table(cfg)
        pad = ((READ_LEN + 1 - k + 7) // 8) * 8 + k - 1
        batches = []
        for i in range(n_steps + 4):
            b = np.zeros((rows, pad), np.uint8)
            b[:, :READ_LEN] = reads[i * rows:(i + 1) * rows]
            batches.append((jnp.asarray(b),
                            jnp.full((rows,), READ_LEN, jnp.int32),
                            jnp.ones((rows // 2,), bool)))
        step = BatchStep(table, k=k, depth_per_shard=cfg.depth_per_shard,
                         coverage=cfg.coverage, canonical=cfg.canonical,
                         paired=True)
        state = table.init()
        for b in batches[:4]:  # compile + warm
            state, keep, _, _ = step.step(state, *b)
        jax.block_until_ready((state, keep))
        hlo = step._step.lower(state, *batches[0]).compile().as_text()
        tdir = os.path.join(out_dir, f"trace_k{k}")
        shutil.rmtree(tdir, ignore_errors=True)
        os.makedirs(tdir)
        with open(os.path.join(tdir, "step_hlo.txt"), "w") as f:
            f.write(hlo)
        jax.profiler.start_trace(tdir)
        for i, b in enumerate(batches[4:]):
            with jax.profiler.StepTraceAnnotation("batch_step", step_num=i):
                state, keep, _, _ = step.step(state, *b)
        jax.block_until_ready((state, keep))
        jax.profiler.stop_trace()
        red = reduce_trace(tdir, hlo, n_steps)
        _emit({"metric": f"device time per batch step by op group (k={k}, "
                         f"{cfg.table_kind} table, {rows} reads/batch)",
               "unit": "ms", "table_capacity": table.capacity,
               "used_slots_after": int(state.used) if k != K else None,
               **red}, tiny)
        del state, batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal at toy sizes (no device numbers)")
    ap.add_argument("--trace", default="", metavar="DIR",
                    help="only trace steady k=15 and k=25 steps into DIR and "
                         "print the per-op-group device time")
    args = ap.parse_args(argv)

    import jax

    from nomalise_kmers_multi_large_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    if jax.devices()[0].platform != "gpu" and not args.tiny:
        print(f"bench.py measures the GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 2
    enable_compile_cache()
    sz = TINY if args.tiny else FULL
    if args.trace:
        trace_lines(sz, args.tiny, args.trace)
        return 0
    failed = []
    jobs = [(name, (lambda n=name, kw=kw: device_line(sz, args.tiny, n, kw)))
            for name, kw in DEVICE_LINES]
    jobs.append(("e2e + host ingest", lambda: e2e_line(sz, args.tiny)))
    for name, job in jobs:
        try:
            job()
        except Exception:
            traceback.print_exc(file=sys.stderr)
            failed.append(name)
    if failed:
        print(f"bench.py: failed lines: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
