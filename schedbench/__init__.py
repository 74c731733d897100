"""Benchmark of the PyTorch and CUDA port's scheduler (see BENCHMARK.json)."""
