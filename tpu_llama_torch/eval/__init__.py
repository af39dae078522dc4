"""Evaluation: teacher-forced perplexity (``ppl``)."""

from tpu_llama_torch.eval.ppl import perplexity, ppl_delta  # noqa: F401
