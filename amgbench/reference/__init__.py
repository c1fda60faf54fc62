"""The plain fp64 references that decide ``correct``.  They import numpy,
scipy and torch only: nothing of the program, and no JAX."""
