"""Reference-exact host helpers (copies of ``tpu_llama.compat``): the
xorshift64* RNG, the samplers, the numpy f64 oracle, the C oracle's runner
and the llama2.c-compatible generation loop."""

from tpu_llama_torch.compat.rng import Xorshift64Star  # noqa: F401
from tpu_llama_torch.compat.sampling import argmax, sample, sample_topp  # noqa: F401
from tpu_llama_torch.compat.oracle import OracleState, oracle_forward  # noqa: F401
from tpu_llama_torch.compat.generate import generate_compat  # noqa: F401
