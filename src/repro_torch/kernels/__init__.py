"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops.py`` dispatches by device: CUDA tensors to the kernels
(``ell_gather.py`` ELL SpMMV, ``cheb_dia.py`` fused DIA Chebyshev step,
built from ``csrc/`` by ``build.py`` at first use), CPU tensors to the
plain versions in ``ref.py``.
"""
