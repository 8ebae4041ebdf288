"""Serving stack of the port: engine, sampling, page pool, tokenizer."""
