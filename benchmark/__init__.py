"""The benchmark of the PyTorch/CUDA port (``windflow_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything a cell is made of is found by
name: ``configs/<config>.json`` (the deployment), ``traffic/<mix>.json``
(the load, read by ``pacing.py``), ``systems/<system>.py`` (how the
deployment is built from the port and fed), ``metrics/<metric>.py`` (one
reader a metric) and ``reference/`` (plain NumPy, which imports nothing of
the port).
"""
