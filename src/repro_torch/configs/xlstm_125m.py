"""Assigned architecture config (see archs.py for the dataclass)."""
from repro_torch.configs.archs import XLSTM_125M as CONFIG
