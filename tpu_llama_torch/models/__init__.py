from tpu_llama_torch.models.llama import (  # noqa: F401
    LayerParams,
    LlamaParams,
    QuantKVCache,
    apply_rope,
    forward_decode,
    forward_prefill,
    greedy_decode_loop,
    make_kv_cache,
    quantize_params,
    random_quant_params,
    rmsnorm,
)
