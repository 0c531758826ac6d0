from shrimp_tpu_torch.io import fastx  # noqa: F401
