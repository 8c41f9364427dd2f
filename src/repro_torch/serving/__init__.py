"""The serving engine of the port."""
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import RetrievalEngine, path_name
from repro_torch.serving.response import RetrievalResponse, ServingStatus

__all__ = ["EngineConfig", "RetrievalEngine", "RetrievalResponse",
           "ServingStatus", "path_name"]
