"""Model definitions of the port (configs, param bridge, quant, transformer)."""
