"""The port's benchmark: see BENCHMARK.json and PERF.md."""
