from dpot_tpu_torch.models.registry import MODEL_PRESETS, build_model

__all__ = ["MODEL_PRESETS", "build_model"]
