"""Low-level ops shared by layers and models: numeric policy,
initializers, activations, attention and the CUDA kernel suite."""

from analytics_zoo_torch.ops import activations, initializers
from analytics_zoo_torch.ops.dtypes import Policy, get_policy, set_policy
