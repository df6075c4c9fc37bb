"""Device labels for every number a measurement prints.

A measurement path names the device it ran on and fails without a GPU;
it never falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def require_gpu() -> dict:
    """Device label {platform, kind, count}; raises unless JAX sees a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX platform is {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
