"""The PyTorch and CUDA port's benchmark (see BENCHMARK.json and PERF.md)."""
