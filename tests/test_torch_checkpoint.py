"""The port's llama2.c checkpoint I/O and dense parameters against the JAX
package's: a file either one writes reads back array-equal in the other,
``make_random_weights`` draws the same arrays for a seed, a truncated file
raises ``ValueError`` in both, and ``params_from_raw`` / ``extend_rope``
give the JAX package's arrays (exact: a transpose and a cast)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JaxModelConfig
from tpu_llama.io import checkpoint as jck
from tpu_llama.models import llama as jl
from tpu_llama_torch import convert
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io import checkpoint as tck
from tpu_llama_torch.models import llama as tl

TINY = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=261,
            seq_len=48, shared_weights=True)
TINY_GQA = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=320, seq_len=64, shared_weights=False)
CONFIGS = {"shared": TINY, "gqa-unshared": TINY_GQA}
FIELDS = [f.name for f in dataclasses.fields(tck.RawWeights) if f.name != "config"]


def _equal(a, b):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))


@pytest.mark.parametrize("cfg", CONFIGS.values(), ids=CONFIGS.keys())
def test_checkpoints_cross_read(cfg, tmp_path):
    """Port-written files load in JAX and JAX-written files in the port;
    the same seed draws the same arrays in both."""
    tw = tck.make_random_weights(ModelConfig(**cfg), seed=5)
    jw = jck.make_random_weights(JaxModelConfig(**cfg), seed=5)
    _equal(tw, jw)
    tck.write_checkpoint(tmp_path / "port.bin", tw)
    jck.write_checkpoint(tmp_path / "jax.bin", jw)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    from_port = jck.load_checkpoint(tmp_path / "port.bin")
    for mmap in (True, False):
        from_jax = tck.load_checkpoint(tmp_path / "jax.bin", mmap=mmap)
        assert dataclasses.asdict(from_jax.config) == dataclasses.asdict(from_port.config)
        _equal(from_jax, from_port)
        assert (from_jax.wcls is from_jax.token_embedding) == cfg["shared_weights"]


def test_truncated_or_padded_checkpoint_raises(tmp_path):
    w = tck.make_random_weights(ModelConfig(**TINY_GQA), seed=1)
    path = tmp_path / "model.bin"
    tck.write_checkpoint(path, w)
    data = path.read_bytes()
    for bad in (data[:-4], data + b"\0" * 4):
        path.write_bytes(bad)
        for load in (tck.load_checkpoint, jck.load_checkpoint):
            with pytest.raises(ValueError):
                load(path)
    with pytest.raises(ValueError):  # a tensor of the wrong shape
        tck.write_checkpoint(path, dataclasses.replace(w, wq=w.wq[:1]))


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_params_from_raw_matches_jax(dtype):
    raw = jck.make_random_weights(JaxModelConfig(**TINY_GQA), seed=2)
    jp = jl.params_from_raw(raw, dtype=dtype[0])
    tp = tl.params_from_raw(convert.raw_weights_from(raw), dtype=dtype[1], device="cpu")
    got, want = convert.params_to_numpy(tp), convert.params_to_numpy(
        convert.params_from_numpy(
            {"layers": {f.name: np.asarray(getattr(jp.layers, f.name), np.float32)
                        for f in dataclasses.fields(jl.LayerParams)},
             **{k: np.asarray(getattr(jp, k), np.float32)
                for k in ("tok_emb", "rms_final", "wcls", "rope_cos", "rope_sin")}},
            device="cpu"))
    for k in ("tok_emb", "rms_final", "wcls", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in got["layers"]:
        np.testing.assert_array_equal(got["layers"][k], want["layers"][k])
    assert tp.layers.wq.dtype == dtype[1] and tp.rope_cos.dtype == torch.float32


def test_extend_rope_and_random_params():
    raw = jck.make_random_weights(JaxModelConfig(**TINY_GQA), seed=3)
    jp = jl.extend_rope(jl.params_from_raw(raw), 100)
    tp = tl.extend_rope(tl.params_from_raw(convert.raw_weights_from(raw), device="cpu"), 100)
    np.testing.assert_array_equal(tp.rope_cos.numpy(), np.asarray(jp.rope_cos))
    np.testing.assert_array_equal(tp.rope_sin.numpy(), np.asarray(jp.rope_sin))
    assert tl.extend_rope(tp, 10) is tp
    cfg = ModelConfig(**TINY_GQA)
    a = tl.random_params(cfg, seed=4, device="cpu")
    b = tl.random_params(cfg, seed=4, device="cpu")
    j = jl.random_params(JaxModelConfig(**TINY_GQA), seed=4)
    for name in ("wq", "wk", "w2"):
        assert getattr(a.layers, name).shape == np.asarray(getattr(j.layers, name)).shape
        assert torch.equal(getattr(a.layers, name), getattr(b.layers, name))
    assert a.tok_emb.dtype == torch.bfloat16 and a.wcls.shape == (48, 320)
    assert 0.015 < float(a.layers.w1.float().std()) < 0.025
    np.testing.assert_array_equal(a.rope_cos.numpy(), np.asarray(j.rope_cos))
    f = tl.random_params(cfg, dtype=torch.float32, seed=4, device="cpu")
    assert f.layers.wo.dtype == torch.float32
