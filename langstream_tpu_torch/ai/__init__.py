"""The AI service SPI of the port and its PyTorch serving provider
(completions and embeddings)."""
