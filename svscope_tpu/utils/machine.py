"""What a measurement ran on: the JAX device, the GPU card's name and
power limit, and the host CPU.

A card may be set below its maximum power and then runs slower under
load, so every timing this repository prints carries the card line
beside it; stage A (host POA) follows the host's cores and SIMD ISA.
Nothing here imports JAX except `device()`."""
from __future__ import annotations

import os
import subprocess


def card() -> str | None:
    """`name, power.limit` of each GPU from nvidia-smi (one line per
    card), or None when nvidia-smi is absent or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def host() -> dict:
    """Host cores and whether the CPU has AVX-512 (native/poa_engine.cpp
    has a non-AVX-512 path that is slower)."""
    avx512 = False
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    avx512 = "avx512f" in line.split()
                    break
    except OSError:
        pass
    return {"nproc": os.cpu_count(), "avx512": avx512}


def device() -> dict:
    """JAX's default device: platform, device_kind and device count."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
