"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version (``ref.py``) and a wrapper (``ops.py``) that counts launches."""
