"""Compatibility re-exports (the reference's `core/pipeline.py`): the
pipeline is the stage graph of `repro_torch.core.graph`, run by the plans
of `repro_torch.core.plans` behind `Preprocessor`:

    from repro_torch.core.plans import Preprocessor
    pre = Preprocessor(cfg, plan="two_phase")
    for res in pre.run(loader): ...
"""
from __future__ import annotations

from repro_torch.core.graph import PipelineGraph, PipelineOutput  # noqa: F401
