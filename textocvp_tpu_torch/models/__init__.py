from textocvp_tpu_torch.models.factory import setup_model, setup_predictor

__all__ = ["setup_model", "setup_predictor"]
