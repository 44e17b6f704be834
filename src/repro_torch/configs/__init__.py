from repro_torch.configs.archs import ALL as ARCHS
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, cell_is_runnable, reduced,
)
from repro_torch.configs.serf_audio import (
    SERF_AUDIO, AudioPipelineConfig, from_reference_config,
)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


__all__ = ["ARCHS", "SERF_AUDIO", "SHAPES", "AudioPipelineConfig",
           "ModelConfig", "ShapeConfig", "cell_is_runnable",
           "from_reference_config", "get_config", "list_archs", "reduced"]
