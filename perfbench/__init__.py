"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness`` holds
the run, ``sut`` the one module that imports the program, ``reference``
the plain answers every served answer is held to, ``corpus`` and
``traffic`` the seeded inputs, ``tracing`` the traced run's readings,
``roofline`` the kernels' traffic arithmetic, and ``metrics/`` one reader
per metric.  Nothing here imports ``jax`` or ``repro``.
"""
