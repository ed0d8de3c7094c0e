"""Foreign-model layers and loaders (port of the JAX package's
``pipeline/api/net``)."""

from analytics_zoo_torch.pipeline.api.net.torch_net import (TorchCriterion,
                                                            TorchNet)
from analytics_zoo_torch.pipeline.api.net.tf_net import TFNet
from analytics_zoo_torch.pipeline.api.net.net import Net

__all__ = ["TorchNet", "TorchCriterion", "TFNet", "Net"]
