"""Keras-style bundled dataset loaders (a copy of the JAX package's
``pipeline/api/keras/datasets``, numpy only).

Reference: pyzoo/zoo/pipeline/api/keras/datasets/ (mnist, imdb,
boston_housing, reuters) — thin loaders the examples/notebooks build
on.  Zero-egress environment: each ``load_data`` reads the standard
Keras archive from a LOCAL ``path`` when given, and otherwise returns
a deterministic synthetic dataset of the same shape/dtype/range so
every example and test runs without a download.
"""

from analytics_zoo_torch.pipeline.api.keras.datasets import (  # noqa: F401
    boston_housing, imdb, mnist, reuters)
