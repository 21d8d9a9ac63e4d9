"""Model substrate: the configs' dataclass, shared layers and the RWKV-6
(ssm) family in PyTorch."""
