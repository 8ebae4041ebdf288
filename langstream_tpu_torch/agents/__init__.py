"""Agents of the port: the vector stores the RAG pipelines query."""
