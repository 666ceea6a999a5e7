"""The benchmark of ``sige_torch`` on one H100: stacked editing sessions
of the port's ``SessionServer``, measured end to end and layer by layer,
checked against a plain PyTorch reference (``sigebench/reference``).

Entry point: ``python3 -m sigebench.run`` (see ``sigebench/run.py``).
Configurations are ``sigebench/configs/<name>.json``, traffic mixes
``sigebench/traffic/<name>.json`` read by ``sigebench/traffic.py``,
per-layer metrics ``sigebench/layers/<name>.py``: each found by the name
``BENCHMARK.json`` gives it.
"""
