"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import LLAMA3_2_3B as CONFIG
