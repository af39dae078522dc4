"""Tensor parallelism over ``torch.distributed`` (port of tpu_llama/parallel):
the (data, model) process mesh, the parameter and cache split rules, the
explicit-TP decode and prefill, the sharded engine's forward (``spmd``: JAX's
GSPMD program), the ring collective matmul, and the rank processes that run
them (``launch``)."""

from tpu_llama_torch.models.llama import tp_interleave  # noqa: F401
from tpu_llama_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    init_distributed,
    make_mesh,
    single_device_mesh,
)
from tpu_llama_torch.parallel.sharding import (  # noqa: F401
    cache_pspec,
    logits_pspec,
    params_pspecs,
    shard_cache,
    shard_params,
    shard_params_spmd,
)
from tpu_llama_torch.parallel.spmd import (  # noqa: F401
    spmd_forward_decode,
    spmd_forward_prefill,
)
from tpu_llama_torch.parallel.tp import (  # noqa: F401
    tp_forward_decode,
    tp_forward_decode_fused,
    tp_forward_prefill,
    tp_prefill_into_slots,
)
