"""portbench: the benchmark of the PyTorch/CUDA port ``repro_torch``
(see ``BENCHMARK.json`` at the root of the repository and ``run.py``)."""
