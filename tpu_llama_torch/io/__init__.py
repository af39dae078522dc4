"""Checkpoint I/O (``checkpoint``) and tokenizer constants (``tokenizer``;
the tokenizer itself comes with the HTTP slice)."""

from tpu_llama_torch.io.checkpoint import (  # noqa: F401
    RawWeights,
    load_checkpoint,
    make_random_weights,
    write_checkpoint,
)
