"""The port stands alone: importing every ``tpu_llama_torch`` module (the
``parallel`` package included) and ``chip_smoke.py`` pulls in neither
``jax`` nor ``tpu_llama``, and its entry points default to the card (and so
raise where there is none)."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_llama_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(tpu_llama_torch.__path__,
                                                        "tpu_llama_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    assert "tpu_llama_torch.ops._kernels" in mods and "tpu_llama_torch.convert" in mods
    assert "tpu_llama_torch.ops.sampling" in mods and "tpu_llama_torch.device" in mods
    assert "tpu_llama_torch.io.checkpoint" in mods
    assert "tpu_llama_torch.runtime.paged" in mods and "tpu_llama_torch.runtime.native_pool" in mods
    assert {f"tpu_llama_torch.parallel.{m}" for m in ("mesh", "sharding", "tp", "overlap",
                                                     "launch", "spmd")} <= set(mods)
    # the sharded engine and its controller (parallel.launch.MeshEngine)
    from tpu_llama_torch.parallel import launch, spmd

    assert callable(spmd.spmd_forward_decode) and callable(launch.MeshEngine)
    # the text surface and the server
    assert {f"tpu_llama_torch.{m}" for m in (
        "cli", "native", "io.tokenizer", "io.fast_bpe", "compat.oracle", "compat.native_oracle",
        "compat.generate", "eval", "eval.ppl", "runtime.health", "runtime.server", "utils",
        "utils.engine_config", "utils.profiling")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tpu_llama' or m.startswith('tpu_llama.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # imports inside functions too: no statement of the port or of
    # chip_smoke.py names jax or the JAX package
    pattern = re.compile(r"^\s*(from|import)\s+(jax|tpu_llama)(\.|\s|$)", re.M)
    files = [ROOT / "chip_smoke.py", *(ROOT / "tpu_llama_torch").rglob("*.py")]
    assert [str(f) for f in files if pattern.search(f.read_text())] == []


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour is not observable")


def test_engine_without_device_raises_without_card():
    _no_card()
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import Engine

    cfg = ModelConfig(dim=32, hidden_dim=64, n_layers=1, n_heads=2, n_kv_heads=2,
                      vocab_size=64, seq_len=16)
    params = tl.random_quant_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.random_quant_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.make_kv_cache(cfg, 1)


def test_library_name_hashes_every_included_header(tmp_path, monkeypatch):
    """An edit to a header that a source includes, directly or through
    another header, names a new library, so it rebuilds; other sources keep
    theirs."""
    from tpu_llama_torch.ops import _kernels

    # K11, K12, K26, K27, K23 and K24 run fused_step2.cuh's streaming body
    for src in ("fused_step2.cu", "fused_step3.cu", "fused_layer.cu", "fused_step.cu",
                "fused_ffn.cu", "fused_rms_qkv.cu"):
        real = [p.name for p in _kernels._headers(ROOT / "tpu_llama_torch/csrc" / src)]
        assert real == ["common.cuh", "decode_split.cuh", "fused_decode.cuh", "fused_step2.cuh",
                        "hopper.cuh"], (src, real)
    # K6's INT8 form and K16 share the bf16 tensor-core cell; K6's fp forms run the
    # split-TF32 cell, which takes the bf16 cell's helpers
    for src, want in (("flash_prefill.cu", ["common.cuh", "prefill_mma.cuh",
                                            "prefill_split.cuh"]),
                      ("paged_flash_prefill.cu", ["common.cuh", "prefill_mma.cuh"])):
        real = [p.name for p in _kernels._headers(ROOT / "tpu_llama_torch/csrc" / src)]
        assert real == want, (src, real)
    monkeypatch.setattr(_kernels, "_CSRC", tmp_path)
    (tmp_path / "common.cuh").write_text("// common\n")
    (tmp_path / "shared.cuh").write_text('#include "common.cuh"\n// v1\n')
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "common.cuh"\n')
    assert _kernels._headers(tmp_path / "a.cu") == [tmp_path / "common.cuh",
                                                    tmp_path / "shared.cuh"]
    a, b = _kernels._lib_path("a"), _kernels._lib_path("b")
    (tmp_path / "shared.cuh").write_text('#include "common.cuh"\n// v2\n')
    assert _kernels._lib_path("a") != a and _kernels._lib_path("b") == b
    (tmp_path / "common.cuh").write_text("// common, edited\n")
    assert _kernels._lib_path("b") != b


def test_build_returns_stored_logs_of_built_libraries(tmp_path, monkeypatch):
    """A library built earlier is not rebuilt, and build() still returns the
    compiler log of that build (registers, spills) for every source."""
    from tpu_llama_torch.ops import _kernels

    def no_nvcc():
        raise AssertionError("nvcc must not run for built libraries")

    monkeypatch.setattr(_kernels, "_BUILD", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    for n in _kernels.SOURCES:
        _kernels._lib_path(n).write_bytes(b"")
        _kernels._log_path(n).write_text(f"ptxas info: {n} Used 32 registers")
    logs = _kernels.build()
    assert logs == {n: f"ptxas info: {n} Used 32 registers" for n in _kernels.SOURCES}
    _kernels._log_path("kv_scatter").unlink()  # a library without its log rebuilds
    with pytest.raises(AssertionError, match="nvcc must not run"):
        _kernels.build(["kv_scatter"])
