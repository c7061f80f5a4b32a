"""Optimizer-side code of the port (the grouped adapter layout so far)."""
