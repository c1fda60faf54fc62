"""CPU tests of the benchmark harness (`python -m pytest amgbench/tests`)."""
