"""The benchmark of ``raptor_tpu_torch`` on NVIDIA H100 cards.

One run measures one cell: ``python -m amgbench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  A cell (``cells/<cell>.json``)
names a configuration (``configs/<config>.json``: operator, engine, solver
settings, correctness limit), a traffic mix (``traffic/<mix>.json``: the
parameters that ``generator.py`` reads) and its per-layer metrics (each a
reader ``metrics/<metric>.py``).  ``spec.py`` finds all of them by name, so
a cell, mix or metric is added by adding files.  ``reference/`` holds the
plain fp64 checks; it imports nothing of the program.
"""
