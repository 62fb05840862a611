"""One reader per metric: ``<metric>.py`` with ``read(ctx)`` returning a
number, or None where the run holds nothing to read."""
