"""What a measurement or smoke run reports about the device it ran on."""

from __future__ import annotations

import subprocess

import jax


def describe() -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card); a card
    set below its top power limit runs slower under load, so every number
    is reported beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"


def require_gpu(prog: str) -> None:
    """Refuse to measure anything but the GPU: no fallback to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"{prog}: needs an NVIDIA GPU; JAX backend is "
                         f"{backend!r}")
