"""GAN training (port of the JAX package's ``tfpark/gan``)."""

from analytics_zoo_torch.tfpark.gan.gan_estimator import (  # noqa: F401
    GANEstimator, least_squares_discriminator_loss,
    least_squares_generator_loss, modified_discriminator_loss,
    modified_generator_loss, wasserstein_discriminator_loss,
    wasserstein_generator_loss)
