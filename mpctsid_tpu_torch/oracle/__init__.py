"""Independent CPU reference implementation (numpy, float64).

The reference repo's native solvers (OSQP for the centroidal MPC, eiquadprog-in-TSID
for the WBC; SURVEY.md §2.1) are not installed and the reference tree is empty
(SURVEY.md §0), so this package IS the parity target demanded by BASELINE.json:5
("control error < 1e-4 vs the CPU reference").  It is written as straightforward
loop-based numpy, deliberately structured differently from the JAX path, and solves
every QP to ~machine precision (ADMM to 1e-8 + active-set KKT polish).

This is the PyTorch port's own copy of the JAX package's oracle: each module
equals its original once the package name is replaced, and it stays numpy
float64 (no torch), so that it checks the port's arithmetic instead of
sharing it.  The port imports nothing from the JAX package, and
``chip_smoke.py`` needs the reference on the card's host, hence the copy;
tests/test_torch_oracle.py holds it byte-equal and bit-equal in its results.
"""
