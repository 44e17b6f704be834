"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import ARCTIC_480B as CONFIG
