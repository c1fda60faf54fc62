"""Engines: the code that drives one engine of the program for a cell.

Each module gives ``Engine(config, stream, dev, faults)`` with ``setup()``,
``step(k)``, ``vcycle()``, ``counts()``, ``control(k)``, ``free()`` and
``judge(sample)``.  ``judge`` computes the fp64 residual with ``amgbench.reference``
only, from the seed's inputs and the program's answer."""
