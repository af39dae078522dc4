"""The port's reference-exact surface on the CPU against the JAX package
and the golden fixture (tests/golden/tiny_golden.json):

* ``compat.oracle.oracle_forward`` equals JAX's bit for bit (both numpy:
  f64 compute, f32 stores, the same operations in the same order);
* ``compat.generate.generate_compat`` on the port's oracle, and the C oracle
  (``compat.native_oracle``, where a compiler builds it) on the same
  checkpoint and tokenizer files, reproduce all four golden cases;
* the engine drives ``generate_compat`` (one decode per position, f32
  cache, "highest" precision) to the golden greedy stream;
* ``Engine.prefill_with_all_logits`` equals JAX's within 1e-5 of max
  |logit| on a dense f32 cache (f32 on both sides, sums in another order:
  tests/test_torch_dense_model.py's limit) and 1e-3 on a paged INT8 cache
  (K and V rounded to int8 on both sides from f32 values a few ulps apart
  can land one step apart; readings 3e-7);
* ``eval.perplexity`` and ``ppl_delta`` equal JAX's within 1e-5 relative on
  f32 weights and 1e-3 on Q8_0 (K25 rounds its activations to bf16, where
  f32 values a few ulps apart can round apart; readings 2e-5).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_llama.compat import generate as jgen
from tpu_llama.compat import oracle as jor
from tpu_llama.config import ModelConfig as JaxModelConfig
from tpu_llama.eval import perplexity as jax_perplexity
from tpu_llama.eval import ppl_delta as jax_ppl_delta
from tpu_llama.io.checkpoint import make_random_weights
from tpu_llama.models import params_from_raw as jax_params_from_raw
from tpu_llama.models import quantize_params as jax_quantize_params
from tpu_llama.runtime import Engine as JaxEngine
from tpu_llama_torch import convert
from tpu_llama_torch.compat import generate as tgen
from tpu_llama_torch.compat import native_oracle
from tpu_llama_torch.compat import oracle as tor
from tpu_llama_torch.eval import perplexity, ppl_delta
from tpu_llama_torch.io import tokenizer as ttok
from tpu_llama_torch.io import write_checkpoint
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.runtime import Engine

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "tiny_golden.json").read_text())
CASES = ["greedy_seed1", "sampled_t08_seed7", "topp_t09_p09_seed3", "no_prompt_seed5"]
TINY_GQA = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=320,
                seq_len=64, shared_weights=False)


def _port_tokenizer(tiny_tokenizer):
    return ttok.Tokenizer(tiny_tokenizer.vocab, tiny_tokenizer.scores,
                          raw_bytes=tiny_tokenizer.raw_bytes)


@pytest.fixture(scope="module")
def files(tmp_path_factory, tiny_weights, tiny_tokenizer):
    """The golden checkpoint and tokenizer, written by the port."""
    d = tmp_path_factory.mktemp("golden")
    write_checkpoint(d / "model.bin", convert.raw_weights_from(tiny_weights))
    _port_tokenizer(tiny_tokenizer).save(d / "tokenizer.bin")
    return d / "model.bin", d / "tokenizer.bin"


@pytest.mark.parametrize("which", ["tiny", "gqa"])
def test_oracle_forward_bit_equal(which, tiny_weights):
    jraw = tiny_weights if which == "tiny" else make_random_weights(
        JaxModelConfig(**TINY_GQA), seed=99)
    traw = convert.raw_weights_from(jraw)
    js, ts = jor.OracleState.create(jraw.config), tor.OracleState.create(traw.config)
    for pos, token in enumerate([1, 262, 35, 5, 319, 0, 100]):
        want = jor.oracle_forward(token, pos, jraw.config, js, jraw)
        got = tor.oracle_forward(token, pos, traw.config, ts, traw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.key_cache, js.key_cache)
    np.testing.assert_array_equal(ts.value_cache, js.value_cache)
    np.testing.assert_array_equal(ts.x, js.x)


@pytest.mark.parametrize("case", CASES)
def test_generate_compat_matches_golden(case, tiny_weights, tiny_tokenizer):
    cfg = GOLDEN[case]["config"]
    raw = convert.raw_weights_from(tiny_weights)
    st = tor.OracleState.create(raw.config)
    got = tgen.generate_compat(lambda t, p: tor.oracle_forward(t, p, raw.config, st, raw),
                               _port_tokenizer(tiny_tokenizer), seq_len=raw.config.seq_len,
                               **cfg)
    assert got.tokens == GOLDEN[case]["tokens"]
    assert got.text == GOLDEN[case]["text"]


def test_generate_compat_step_rules(tiny_weights, tiny_tokenizer):
    """``-n 0`` and steps past seq_len run to seq_len (llama2.ts:439); seed
    0 seeds from the clock; both loops give the same streams and text."""
    jraw, traw = tiny_weights, convert.raw_weights_from(tiny_weights)
    ttk = _port_tokenizer(tiny_tokenizer)
    for steps in (0, 500):
        js, ts = jor.OracleState.create(jraw.config), tor.OracleState.create(traw.config)
        kw = dict(prompt="On", steps=steps, temperature=0.0, seed=1, seq_len=64)
        want = jgen.generate_compat(lambda t, p: jor.oracle_forward(t, p, jraw.config, js, jraw),
                                    tiny_tokenizer, **kw)
        got = tgen.generate_compat(lambda t, p: tor.oracle_forward(t, p, traw.config, ts, traw),
                                   ttk, **kw)
        assert got.tokens == want.tokens and got.text == want.text
        assert len(got.tokens) <= 64
    ts = tor.OracleState.create(traw.config)
    seeded = tgen.generate_compat(lambda t, p: tor.oracle_forward(t, p, traw.config, ts, traw),
                                  ttk, prompt="On", steps=6, temperature=1.0, seed=0, seq_len=64)
    assert len(seeded.tokens) <= 6


@pytest.mark.parametrize("case", CASES)
def test_native_oracle_matches_golden(case, files):
    if native_oracle.build_oracle() is None:
        pytest.skip("no C compiler available")
    cfg = dict(GOLDEN[case]["config"])
    cfg["prompt"] = cfg["prompt"] or ""
    assert native_oracle.run_oracle(*files, **cfg) == GOLDEN[case]["tokens"]


def test_engine_drives_generate_compat_to_golden_greedy(tiny_weights, tiny_tokenizer):
    """One decode per position through the port's Engine (f32 cache,
    "highest"), teacher-forced by ``generate_compat``: the golden greedy
    stream and text."""
    case = GOLDEN["greedy_seed1"]
    raw = convert.raw_weights_from(tiny_weights)
    eng = Engine(tl.params_from_raw(raw, device="cpu"), raw.config, max_batch=1,
                 precision="highest", device="cpu")

    def forward(token, pos):
        return eng.decode(np.array([token]), np.array([pos]))[0]

    got = tgen.generate_compat(forward, _port_tokenizer(tiny_tokenizer),
                               seq_len=raw.config.seq_len, **case["config"])
    assert got.tokens == case["tokens"] and got.text == case["text"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_with_all_logits_equals_jax(layout, tiny_weights):
    raw = convert.raw_weights_from(tiny_weights)
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    je = JaxEngine(jax_params_from_raw(tiny_weights), tiny_weights.config, max_batch=2,
                   precision="highest", **kw)
    te = Engine(tl.params_from_raw(raw, device="cpu"), raw.config, max_batch=2,
                precision="highest", device="cpu", **kw)
    tol = 1e-5 if layout == "dense" else 1e-3
    rng = np.random.default_rng(3)
    for slot, n in ((1, 37), (0, 5), (1, 64)):
        prompt = [1] + [int(t) for t in rng.integers(3, raw.config.vocab_size, n - 1)]
        want = je.prefill_with_all_logits(prompt, slot)
        got = te.prefill_with_all_logits(prompt, slot)
        assert got.shape == want.shape == (n, raw.config.vocab_size)
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), (n, err)
        # the slot's cache then holds the prompt: the next decode agrees too
        tok, pos = np.zeros(2, np.int64), np.zeros(2, np.int64)
        if n < raw.config.seq_len:
            tok[slot], pos[slot] = int(np.argmax(want[-1])), n
            a, b = je.decode(tok, pos)[slot], te.decode(tok, pos)[slot]
            assert np.abs(b - a).max() <= tol * np.abs(a).max()
    if layout == "paged":
        assert te.pool.free_pages == je.pool.free_pages
    with pytest.raises(ValueError):
        te.prefill_with_all_logits([], 0)


def test_perplexity_and_delta_equal_jax(tiny_weights, rng_np):
    raw = convert.raw_weights_from(tiny_weights)
    c = raw.config
    jp = jax_params_from_raw(tiny_weights)
    tp = tl.params_from_raw(raw, device="cpu")
    tokens = rng_np.integers(0, c.vocab_size, size=100).tolist()
    for chunk in (None, 31):
        want = jax_perplexity(jp, tiny_weights.config, tokens, chunk=chunk, precision="highest")
        got = perplexity(tp, c, tokens, chunk=chunk, precision="highest")
        assert abs(got - want) <= 1e-5 * want, (chunk, got, want)
        assert 1.0 < got < 10 * c.vocab_size
    want = jax_ppl_delta(jp, jax_quantize_params(jp), tiny_weights.config, tokens,
                         precision="highest")
    got = ppl_delta(tp, tl.quantize_params(tp), c, tokens, precision="highest")
    assert abs(got[0] - want[0]) <= 1e-5 * want[0]
    assert abs(got[1] - want[1]) <= 1e-3 * want[1]
    assert abs(got[2] - (got[1] - got[0])) < 1e-9
