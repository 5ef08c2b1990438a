"""portbench: the benchmark of the PyTorch + CUDA port
(`tinypathtracer_tpu_torch`) on one NVIDIA card.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`. Everything that
belongs to one configuration, traffic mix, per-layer metric or cell
lives in its own file, found by name (README.md).
"""
