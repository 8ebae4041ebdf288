"""Attention kernels of the port: hand-written CUDA for Hopper + plain versions."""
