"""The benchmark of the PyTorch and CUDA port (`ovr_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json`; configurations, traffic
mixes, metrics, content generators and the comparison's limits are
files of their own here, found by the names in `BENCHMARK.json`.
Only `run.py` imports the program; the yardstick (the reference,
`work.py`, `check.py`, `frames.py`, the metric readers) imports none of
it.
"""
