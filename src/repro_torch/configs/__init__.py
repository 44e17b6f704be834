from repro_torch.configs.serf_audio import (
    SERF_AUDIO, AudioPipelineConfig, from_reference_config,
)

__all__ = ["SERF_AUDIO", "AudioPipelineConfig", "from_reference_config"]
