"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import GEMMA_7B as CONFIG
