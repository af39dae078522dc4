"""Reference-exact host helpers (copies of ``tpu_llama.compat``)."""
