"""The LM train step (port of ``repro.train``)."""
