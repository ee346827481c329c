"""The benchmark of accl_tpu_torch on one NVIDIA H100: cells found by
name from BENCHMARK.json, run by `python3 -m cardbench.run` (README.md)."""
