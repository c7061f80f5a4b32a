"""Optimizer-side code of the port: global-norm clipping, LR schedules
and the grouped low-rank subspace optimizer (counterpart of
``repro.optim``)."""
