"""Projection samplers of the port (counterpart of ``repro.core``)."""
