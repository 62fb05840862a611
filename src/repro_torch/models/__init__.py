"""The LM-architecture zoo of the port: all ten configs' parameter trees
and serve paths (forward, prefill, decode)."""
