"""The benchmark's plain reference: structured-grid finite elements, the
yield functions and the cutting-plane return map, in plain PyTorch.

Nothing here imports the program under test, JAX or the JAX package: the
reference builds its geometry, boundary conditions and stiffness from the
configuration file and the raw SVC file alone.
"""
