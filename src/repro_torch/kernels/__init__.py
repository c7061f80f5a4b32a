"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (:mod:`.ref`), routed by :mod:`.dispatch`."""
