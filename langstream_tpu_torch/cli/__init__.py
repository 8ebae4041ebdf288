"""The port's command line (``python -m langstream_tpu_torch.cli``)."""
