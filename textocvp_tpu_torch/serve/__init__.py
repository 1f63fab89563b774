from textocvp_tpu_torch.serve.pipeline import InferenceFrontend, PredictionService
from textocvp_tpu_torch.serve.server import serve

__all__ = ["InferenceFrontend", "PredictionService", "serve"]
