"""Low-level ops shared by layers and models: numeric policy,
initializers, activations, attention and the CUDA kernel suite."""
