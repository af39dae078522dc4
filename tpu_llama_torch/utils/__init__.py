"""Deployment configuration (``EngineConfig``) and tracing (``profile_trace``)."""

from tpu_llama_torch.utils.engine_config import EngineConfig, ServerConfig  # noqa: F401
from tpu_llama_torch.utils.profiling import profile_trace  # noqa: F401
