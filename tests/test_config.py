"""Configuration rules that hold on every backend: the 'auto' table choice
and the persistent compilation cache's placement."""
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from nomalise_kmers_multi_large_tpu.config import Config
from nomalise_kmers_multi_large_tpu.table import DirectTable, HashedTable, make_table
from nomalise_kmers_multi_large_tpu.utils import compile_cache
from nomalise_kmers_multi_large_tpu.utils.compile_cache import (
    ENV_VAR,
    cache_dir,
    enable_compile_cache,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("k,depth,want", [
    (5, 2, "direct"), (11, 100, "direct"), (15, 100, "direct"),
    (15, 70_000, "direct"), (16, 100, "hashed"), (21, 200, "hashed"),
    (25, 200, "hashed"), (31, 70_000, "hashed"),
])
def test_auto_table_kind(k, depth, want):
    """'auto' is one rule on every backend: the dense direct table while
    4^k slots fit (k <= 15), the hashed table above; depth plays no part."""
    cfg = Config(forward_files=("x.fastq",), single=True, ksize=k,
                 depth=depth).validate()
    assert cfg.table_kind == want
    table = make_table(cfg)
    assert isinstance(table, DirectTable if want == "direct" else HashedTable)


def test_auto_table_kind_ignores_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = Config(forward_files=("x.fastq",), single=True, ksize=15)
    assert cfg.table_kind == "direct"


def test_explicit_table_kept():
    cfg = Config(forward_files=("x.fastq",), single=True, ksize=11,
                 table="hashed").validate()
    assert cfg.table_kind == "hashed"


def test_compile_cache_env_set_configures_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_path_stable_across_processes(tmp_path):
    """The default path depends on the checkout alone: not on the working
    directory, a pid, a clock or a temp dir."""
    env = {k: v for k, v in os.environ.items() if k != ENV_VAR}
    env["PYTHONPATH"] = str(REPO)
    code = ("from nomalise_kmers_multi_large_tpu.utils.compile_cache "
            "import cache_dir; print(cache_dir())")
    seen = set()
    for sub in ("a", "b"):
        cwd = tmp_path / sub
        cwd.mkdir()
        out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                             capture_output=True, text=True, check=True)
        seen.add(out.stdout.strip())
    assert seen == {compile_cache.DEFAULT_DIR}
