"""Kernels of the port and their plain PyTorch versions.

Each public op launches its hand-written CUDA kernel for CUDA tensors and
runs its plain PyTorch version for CPU tensors (see ``_kernels``).
"""

from tpu_llama_torch.ops.attention import (  # noqa: F401
    flash_decode_attention_dma,
    flash_decode_attention_fresh,
    flash_prefill_attention,
    kv_cache_flush_rows,
    kv_cache_scatter_slots,
    quantize_kv,
)
from tpu_llama_torch.ops.matmul import w8a8_matmul, w8a8_matmul_prequant  # noqa: F401
from tpu_llama_torch.ops.quant import (  # noqa: F401
    ChannelQuantTensor,
    dequantize_channel,
    quantize_activations,
    quantize_channel,
    rmsnorm_quantize,
    rope_split_quantize,
    silu_mul_quantize,
)
