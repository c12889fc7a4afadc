"""The benchmark of the PyTorch/CUDA port ``bundlefusion_tpu_torch``.

Run one cell from the repository root:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix
and per-layer metrics are files under this folder, found by name
(``spec.py``). Nothing here imports JAX or the JAX package.
"""
