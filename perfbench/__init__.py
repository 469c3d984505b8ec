"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of GraphMP.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell needs is found by name:

- ``configs/<config>.json``: the graph and the engine settings;
- ``traffic/<traffic>.json``: the mix's parameters, read by ``mixes.py``;
- ``programs/<program>.py``: what a mix's requests run and how each
  answer is compared with the plain reference (``reference/``);
- ``generators/<kind>.py``: a configuration's edge list, made on the card;
- ``metrics/<metric>.py``: one reader per metric, ``read(record)``; a
  quantity split by the cells that report it (``host_ms.pr``) is read by
  ``metrics/<quantity>.py`` (``host_ms.py``) unless it has a file of its
  own.

The graphs (``graphs.py``), the plain reference, the comparison that
decides ``correct`` (``mixes.py`` and ``programs/``), the byte counts and
peaks (``roofline.py``) and the trace reduction (``devtrace.py``) are the
benchmark's own: nothing here imports ``jax`` or the JAX package, and
only the harness imports the port.
"""
