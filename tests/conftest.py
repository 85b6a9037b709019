"""Test configuration: force an 8-device virtual CPU mesh before JAX imports.

Multi-device logic is tested without accelerators per SURVEY.md section 4: CPU
devices simulate the mesh. What only the card can show (compilation for the
GPU, device memory, GPU scatter semantics) is checked by ``chip_smoke.py``.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pytest

#: Tests that dominate the full suite (big fixtures, mesh runs,
#: multi-process). `-m "not slow"` is the quick gate; the full suite
#: (default) remains the gate for anything touching decision semantics.
_SLOW = {
    "test_dispatch_group_multi_shard",
    "test_multi_file_paired_fasta_out", "test_mixed_paired_and_single",
    "test_mesh_checkpoint_resume", "test_wide_table_checkpoint_roundtrip",
    "test_two_process_mode_a_aggregation",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW:
            item.add_marker(pytest.mark.slow)

