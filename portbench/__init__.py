"""The card benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. A configuration is a file of
``configs/`` that names its architecture module of ``archs/`` (``"arch"``),
a traffic mix a file of ``traffic/``, a cell's correctness limits a file of
``limits/``, and a metric a reader of ``metrics/``, each found by its name.
Nothing here imports ``jax``, ``jaxlib`` or ``repro``.
"""
