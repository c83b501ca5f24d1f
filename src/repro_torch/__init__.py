"""PyTorch/CUDA port of the filter-diagonalization eigensolver.

Beside ``repro`` (the JAX package, which stays the reference), with its
layout and names: ``matrices`` (host generators), ``kernels`` (the CUDA
kernels for Hopper and their plain versions), ``core`` (SpMV, filter,
Lanczos, orthogonalization, the FD driver), ``convert`` (the reference's
host objects into the port's), ``launch.solve`` (the CLI), and the LM
side: ``models`` (serving and the train step), ``optim`` (AdamW and the
cross-pod compression), ``data`` (the token pipeline) and
``launch.train``. It imports torch, numpy and scipy, never jax or
``repro``.
"""
