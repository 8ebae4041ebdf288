"""The expression language and the record context the port's writers
evaluate against (own copies of ``langstream_tpu/agents/genai``'s)."""
