"""What every measurement names: the JAX device and the card's power limit.

A card can be set below its maximum power and then runs slower under load,
so a number is only comparable with the card's name and limit beside it.
"""
from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def device_fields() -> dict:
    """The first JAX device as JAX reports it, and the device count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card, one line per card, as nvidia-smi
    prints them; a short reason when nvidia-smi cannot answer."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (exit {out.returncode})"
    return out.stdout.strip()
