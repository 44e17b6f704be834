"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import GRANITE_MOE_3B as CONFIG
