"""PyTorch/CUDA port of the Grace Hopper unified-memory reproduction.

A package beside the JAX reference (``repro``) that imports nothing of it:
``core`` is its own copy of the charge model, ``kernels`` holds hand-written
CUDA kernels for Hopper with their plain PyTorch versions, and ``apps`` runs
the paper's apps on the CUDA card (or, when asked, on the CPU).
"""
