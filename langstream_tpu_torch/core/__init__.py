"""The port's resource registry (``core/registry.py``)."""
