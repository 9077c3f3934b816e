from repro_torch.sharding import specs  # noqa: F401
