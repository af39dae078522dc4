from tpu_llama_torch.runtime.engine import Engine  # noqa: F401
from tpu_llama_torch.runtime.paged import PagePool  # noqa: F401
from tpu_llama_torch.runtime.scheduler import ContinuousBatcher, Request  # noqa: F401
