"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import MINITRON_8B as CONFIG
