"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import NEMOTRON_4_15B as CONFIG
