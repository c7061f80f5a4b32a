"""Training of the port: chunked loss, step builders and the loop
(counterpart of ``repro.train``)."""
