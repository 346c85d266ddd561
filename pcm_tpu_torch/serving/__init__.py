from .engine import EngineConfig, InferenceEngine, make_prompt_encoder
from .server import BatchingServer

__all__ = ["EngineConfig", "InferenceEngine", "make_prompt_encoder", "BatchingServer"]
