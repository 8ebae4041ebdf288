"""Completions SPI of the port and its PyTorch serving provider."""
