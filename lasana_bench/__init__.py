"""lasana_bench: the benchmark of the port (see BENCHMARK.json)."""
