from repro_torch.data.pipeline import DataLoader, SyntheticLM  # noqa: F401
