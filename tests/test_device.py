"""Engine choice per backend, the removed engine names, the compile-cache
helper, and the GPU-only entry points' refusal to run anywhere else."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest

from fast_ctc_decode_tpu import device
from fast_ctc_decode_tpu.ops import beam_fast
from fast_ctc_decode_tpu.parallel.mesh import make_data_mesh
from fast_ctc_decode_tpu.parallel.pipeline import (
    BatchBeamDecoder,
    BatchCrfBeamDecoder,
    BatchCrfDuplexDecoder,
    BatchDuplexDecoder,
    decode_and_count,
)

ROOT = Path(__file__).resolve().parent.parent


def _batch(B=8, T=20, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, 5).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True), np.full(
        (B,), T, np.int32
    )


@pytest.mark.parametrize(
    "backend,engine", [("gpu", "pallas"), ("cpu", "fast"), ("rocm", "fast")]
)
def test_beam_engine_by_backend(backend, engine):
    assert device.beam_engine(backend) == engine


def test_auto_engine_on_this_host():
    assert device.beam_engine() == "fast"
    assert BatchBeamDecoder("NACGT", T=20).engine == "fast"


@pytest.mark.parametrize(
    "make",
    [
        lambda: BatchBeamDecoder("NACGT", T=8, engine="exact-pallas"),
        lambda: BatchCrfBeamDecoder("NACGT", T=8, n_state=4, engine="pallas"),
        lambda: BatchDuplexDecoder("NACGT", T1=8, T2=8, engine="pallas"),
        lambda: BatchDuplexDecoder("NACGT", T1=8, T2=8, engine="exact-pallas"),
        lambda: BatchCrfDuplexDecoder(
            "NACGT", T1=8, T2=8, n_state=4, engine="exact-pallas"
        ),
    ],
)
def test_removed_engine_names_raise(make):
    with pytest.raises(ValueError, match="unknown engine"):
        make()


def test_kernel_engine_interprets_only_when_asked():
    probs, lens = _batch()
    with pytest.raises(Exception, match="interpret"):
        BatchBeamDecoder("NACGT", T=20, engine="pallas").decode(probs, lens)
    got = BatchBeamDecoder(
        "NACGT", T=20, engine="pallas", interpret=True
    ).decode(probs, lens)
    assert got == BatchBeamDecoder("NACGT", T=20, engine="fast").decode(
        probs, lens
    )


def test_decode_and_count_kernel_engine_on_mesh():
    """The Triton kernel under shard_map over the 8-device mesh, with the
    psum'd counters, equals the scan engine."""
    probs, lens = _batch(B=16, T=24, seed=3)
    lens[5] = 0
    mesh = make_data_mesh()
    out, totals = decode_and_count(
        mesh, probs, lens, beam_size=5, threshold=0.1, collapse=True,
        engine="pallas", interpret=True,
    )
    ref = beam_fast.beam_search_fast_batch(
        probs, lens, np.float32(0.1), beam_size=5
    )
    assert np.asarray(totals).tolist() == [16, 0]
    for k in ("labels_rev", "times_rev", "count", "err"):
        assert np.array_equal(np.asarray(out[k]), np.asarray(ref[k])), k


def test_compile_cache_env_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert device.use_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.use_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert device.use_compile_cache() == path  # same path every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def _run(script, cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script), *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_fails_without_gpu(args):
    res = _run(ROOT / "chip_smoke.py", ROOT, *args)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("script", ["bench.py", "tests/benchmark.py"])
def test_benchmarks_fail_without_gpu(script):
    res = _run(ROOT / script, ROOT, "--quick")
    assert res.returncode != 0
    assert "no GPU" in res.stderr
