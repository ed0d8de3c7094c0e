from analytics_zoo_torch.pipeline.inference.inference_model import (
    InferenceModel,
)

__all__ = ["InferenceModel"]
