"""The benchmark of the PyTorch/CUDA port (``edge_diffusion_tts_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``reference/`` is the plain PyTorch reference that decides ``correct``; it
imports nothing of the port.  ``harness/`` holds what every cell shares
(manifest, traffic generator, seeded weights, trace reduction, the
comparison), ``drivers/`` one module per kind of traffic, ``counts/`` the
operation and byte counts, ``metrics/`` one reader per per-layer metric,
``configs/``, ``traffic/`` and ``limits/`` one data file per configuration,
traffic mix and cell.  Each is found by the name ``BENCHMARK.json`` gives it.
"""
