"""Traffic kinds (``<kind>.py``), their cells' parameters (``<traffic>.json``)
and the digit generator they share."""
