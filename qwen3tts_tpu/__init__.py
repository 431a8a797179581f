"""qwen3tts_tpu — a JAX (XLA + Pallas) Qwen3-TTS inference framework.

A from-scratch rebuild of the capabilities of the reference CPU/Metal C++
engine (clawd20130/qwen3-tts.cpp): one jitted program per pipeline stage, the
entire autoregressive frame loop on device, weights as pytrees, and
named-axis sharding for multi-device scale-out.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CodePredictorConfig,
    PipelineConfig,
    RuntimeConfig,
    SamplingConfig,
    SpeakerEncoderConfig,
    TalkerConfig,
    VocoderConfig,
    tiny_pipeline_config,
)


def __getattr__(name):
    # lazy: pipeline pulls in jax device init; keep bare imports cheap
    if name in ("Qwen3TTS", "TTSResult"):
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
