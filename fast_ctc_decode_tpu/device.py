"""Where the decoder runs: the engine choice per JAX backend, the persistent
compile cache, and the device facts a measurement must name.

This is the one place that looks at ``jax.default_backend()``.  Nothing
here runs on package import.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

import jax

# fixed, inside the checkout: the cache path is part of JAX's cache key
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def beam_engine(backend: Optional[str] = None) -> str:
    """The batched 1-D beam engine for a JAX backend: the fused Triton
    kernel (``"pallas"``, ops/beam_pallas.py) on ``"gpu"``, the XLA scan
    engine (``"fast"``, ops/beam_fast.py) anywhere else."""
    if backend is None:
        backend = jax.default_backend()
    return "pallas" if backend == "gpu" else "fast"


def use_compile_cache() -> str:
    """Keep compiled programs across processes.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins (JAX reads it itself);
    otherwise the cache lives at the fixed ``<checkout>/.jax_cache``.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the visible cards (one
    line per card), or "" where there is no such tool."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip()


def require_gpu() -> dict:
    """The device a measurement runs on; raises when JAX found no GPU.

    Returns ``{"platform", "kind", "count"}`` as JAX reports them, plus
    ``"card"``: nvidia-smi's name and power limit of the first card."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r}; this measurement "
            "does not fall back to another device"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_line().splitlines()[0] if card_line() else "",
    }
