"""The paper-figure benchmark harness on the port: one module per paper
figure plus ``kernels_micro``, CSV to stdout, driven by
``python -m repro_torch.bench.run [--device cpu] [modules]``."""
