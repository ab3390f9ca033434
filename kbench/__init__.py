"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the repository's root names its cells, metrics and
bounds; ``kbench/run.py`` runs one cell once. A cell is ``cells/<name>.json``
(a configuration, a traffic mix, the serving setup, the limits of the
check), a configuration ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (parameters only; the arrival, length and prompt
laws it names are ``arrivals/<law>.py``, ``lengths/<law>.py`` and
``prompts/<law>.py``) and a metric ``metrics/<name>.py``: a later cell,
mix, law or metric is a file added beside them.
"""
