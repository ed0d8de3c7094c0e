"""Model-zoo base class (port of ``models/common.py``).

A ZooModel is a thin facade over an inner KerasNet graph built by
``build_model``.  This slice serves, so only the variables surface
delegates; compile/fit/evaluate come with the training slice.
"""

from __future__ import annotations


class ZooModel:
    """Base: subclasses implement ``build_model() -> KerasNet``."""

    def __init__(self, **kwargs):
        self.model = self.build_model()

    def build_model(self):
        raise NotImplementedError

    def get_variables(self):
        return self.model.get_variables()

    def set_variables(self, variables):
        self.model.set_variables(variables)

    def get_weights(self):
        return self.model.get_weights()

    def set_weights(self, weights):
        self.model.set_weights(weights)
