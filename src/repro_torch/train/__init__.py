"""Training of the port: chunked loss, step builders, the loop, its
checkpoints, health guard and chaos hooks (counterpart of
``repro.train``)."""
