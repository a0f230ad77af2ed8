"""tsdb_bench: the benchmark of ``filodb_tpu_torch``, the PyTorch and CUDA
port of FiloDB's in-memory query engine.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m tsdb_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Layout (each piece found by the name ``BENCHMARK.json`` gives it):

- ``configs/<config>.json``: a deployment — sizes, source, guarantees;
- ``data/<generator>.py``: its seeded inputs, made on the card, shared by
  the install and the plain reference (imports nothing of the program);
- ``deploy/<builder>.py``: the install of those inputs into the program;
- ``traffic/<mix>.json``: clients, queries, weights, step and ranges;
- ``metrics/<metric>.py``: one reader a per-layer metric;
- ``reference/``: the plain answers a query family, and their limits;
- ``roofline/``: the bytes each hand-written kernel needs, and the peaks.
"""
