"""CPU tests of the benchmark (``python -m pytest cardbench/tests``); the
ones marked ``card`` need a CUDA card and skip without one."""
