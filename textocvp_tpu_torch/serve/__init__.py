from textocvp_tpu_torch.serve.batching import DynamicBatcher
from textocvp_tpu_torch.serve.export import ExportedPredictionService, export_service
from textocvp_tpu_torch.serve.pipeline import InferenceFrontend, PredictionService
from textocvp_tpu_torch.serve.server import serve

__all__ = ["DynamicBatcher", "ExportedPredictionService", "InferenceFrontend",
           "PredictionService", "export_service", "serve"]
