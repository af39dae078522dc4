"""The port's CLI (``tpu_llama_torch.cli``) on the CPU (``--device cpu``):
tests/test_cli.py's contracts (the reference's flag semantics,
llama2.ts:399-424, 514-524), its greedy stdout before the tok/s line equal
to the JAX package's CLI on the same checkpoint and tokenizer, and the
default device being the card (so it raises where there is none)."""

import pytest
import torch

from tpu_llama import cli as jax_cli
from tpu_llama.compat.generate import generate_compat
from tpu_llama.compat.oracle import OracleState, oracle_forward
from tpu_llama_torch import cli

TOKS_LINE = "\n\nachieved tok/s"


@pytest.fixture()
def model_files(tmp_path, tiny_weights, tiny_tokenizer):
    from tpu_llama.io.checkpoint import write_checkpoint

    ckpt, tok = tmp_path / "model.bin", tmp_path / "tokenizer.bin"
    write_checkpoint(ckpt, tiny_weights)
    tiny_tokenizer.save(tok)
    return str(ckpt), str(tok)


def run_cli(args):
    cli.main(args)


def test_missing_checkpoint_usage_exit(capsys):
    with pytest.raises(SystemExit) as e:
        run_cli([])
    assert e.value.code == 1
    assert "Usage:" in capsys.readouterr().err


@pytest.mark.parametrize("bad", [
    ["m.bin", "-t"],            # flag without value (llama2.ts:410)
    ["m.bin", "x", "1"],        # no dash (llama2.ts:412)
    ["m.bin", "-temp", "1"],    # not two chars (llama2.ts:413)
    ["m.bin", "-q", "1"],       # unknown flag (llama2.ts:421)
    ["m.bin", "--device"],      # long flag without value
    ["m.bin", "--device", "tpu"],
    ["m.bin", "--quant", "int4"],
])
def test_strict_flag_pairs(bad, capsys):
    with pytest.raises(SystemExit) as e:
        run_cli(bad)
    assert e.value.code == 1


def test_generate_greedy(model_files, capsys, tiny_weights, tiny_tokenizer):
    ckpt, tok = model_files
    run_cli([ckpt, "--tokenizer", tok, "-t", "0", "-s", "1", "-n", "20",
             "-i", "Once upon a time", "--precision", "highest", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("Once upon a time")
    assert "achieved tok/s:" in out  # llama2.ts:511's line
    c = tiny_weights.config
    st = OracleState.create(c)
    res = generate_compat(lambda t, p: oracle_forward(t, p, c, st, tiny_weights),
                          tiny_tokenizer, prompt="Once upon a time", steps=20,
                          temperature=0.0, seed=1, seq_len=c.seq_len)
    assert out.split(TOKS_LINE)[0] == res.text


@pytest.mark.parametrize("extra", [
    [],  # the default: dense f32 weights, f32 cache, "highest"
    ["--quant", "int8", "--kv-dtype", "bfloat16"],
])
def test_greedy_stdout_equals_jax_cli(extra, model_files, capsys):
    ckpt, tok = model_files
    args = [ckpt, "--tokenizer", tok, "-t", "0", "-s", "1", "-n", "24", "-i", "Once upon a time",
            *extra]
    jax_cli.main(args)
    want = capsys.readouterr().out.split(TOKS_LINE)[0]
    run_cli(args + ["--device", "cpu"])
    got = capsys.readouterr().out.split(TOKS_LINE)[0]
    assert got == want and got.startswith("Once upon a time")


def test_generate_int8(model_files, capsys):
    ckpt, tok = model_files
    run_cli([ckpt, "--tokenizer", tok, "-t", "0", "-s", "1", "-n", "12", "-i", "On",
             "--quant", "int8", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("On")


def test_generate_w8a8_int8_cache(model_files, capsys):
    """The served path's options (fused W8A8 weights, INT8 cache) on the
    CPU's plain versions."""
    ckpt, tok = model_files
    run_cli([ckpt, "--tokenizer", tok, "-t", "0", "-s", "1", "-n", "12", "-i", "On",
             "--quant", "w8a8", "--kv-dtype", "int8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("On") and "achieved tok/s:" in out


def test_steps_zero_uses_seq_len(model_files, capsys):
    """-n 0 runs to seq_len (llama2.ts:439); it ends, with bounded output."""
    ckpt, tok = model_files
    run_cli([ckpt, "--tokenizer", tok, "-t", "0", "-s", "1", "-n", "0", "-i", "On",
             "--device", "cpu"])
    assert "achieved tok/s:" in capsys.readouterr().out


def test_kv_flags_and_sample_device(model_files, capsys):
    """--kv-dtype / --kv-layout / --sample-device: paged INT8 with device
    sampling generates."""
    ckpt, tok = model_files
    run_cli([ckpt, "--tokenizer", tok, "-n", "12", "-i", "Once", "-t", "0", "-s", "1",
             "--kv-dtype", "int8", "--kv-layout", "paged", "--sample-device", "on",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Once" in out and "achieved tok/s:" in out


def test_bad_kv_dtype_exits(model_files):
    ckpt, _ = model_files
    with pytest.raises(SystemExit):
        run_cli([ckpt, "--kv-dtype", "int4"])


def test_default_device_is_the_card(model_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour is not observable")
    ckpt, tok = model_files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli([ckpt, "--tokenizer", tok, "-n", "4", "-i", "On", "-t", "0"])
