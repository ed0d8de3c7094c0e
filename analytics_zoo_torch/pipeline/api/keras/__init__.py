from analytics_zoo_torch.pipeline.api.keras.engine import Input, KTensor, Layer
from analytics_zoo_torch.pipeline.api.keras.topology import (
    KerasNet, Model, Sequential,
)

__all__ = ["Input", "KTensor", "Layer", "KerasNet", "Model", "Sequential"]
