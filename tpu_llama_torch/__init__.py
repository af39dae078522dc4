"""PyTorch + CUDA port of ``tpu_llama`` for one NVIDIA H100.

The JAX package ``tpu_llama`` stays the reference.  This package keeps its
module names; it imports ``torch`` and numpy, never ``jax`` or
``tpu_llama``.  Hand-written Hopper kernels live in ``csrc/`` and are bound
in ``ops/``; entry points run on the card unless the caller passes
``device="cpu"``.
"""

from tpu_llama_torch.config import LLAMA2_7B, ModelConfig  # noqa: F401
