"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import ZAMBA2_1_2B as CONFIG
