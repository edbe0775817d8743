"""The port's runnable examples, each ``python -m repro_torch.examples.<name>
[--device cpu]`` (on the CUDA card by default): ``trace_replay``,
``buffer_api``, ``qv_oversubscription``, ``serve_batched``, ``train_100m``
and ``quickstart``."""
