"""Checkpoint I/O (``checkpoint``) and the tokenizer (``tokenizer``, with
the native encoder in ``fast_bpe``)."""

from tpu_llama_torch.io.checkpoint import (  # noqa: F401
    RawWeights,
    load_checkpoint,
    make_random_weights,
    write_checkpoint,
)
from tpu_llama_torch.io.tokenizer import Tokenizer  # noqa: F401
