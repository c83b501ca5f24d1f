"""The benchmark's plain reference: frozen copies of the matrix generators
(one module a family, each with ``coo(**params)``) and the comparison that
decides ``correct`` (``check.py``). NumPy and SciPy only; nothing here
imports the program."""
