"""Metrics of the port (its own copy of what it needs from
``langstream_tpu/api``)."""
