"""keras2 — the Keras-2 layer API (real classes over the keras-1
engine; port of ``pipeline/api/keras2``).

Reference: zoo/pipeline/api/keras2/layers/ — Dense, Conv1D/2D, pooling
families, Cropping1D, LocallyConnected1D, Softmax(axis), the
Average/Maximum/Minimum merge classes, plus the functional merge
helpers — with keras-2 argument names (units/filters/kernel_size,
kernel_initializer/bias_initializer, padding/data_format).
"""

from analytics_zoo_torch.pipeline.api.keras2.models import (  # noqa: F401
    Model, Sequential)
from analytics_zoo_torch.pipeline.api.keras2.layers import (
    GRU, LSTM, Activation, Add, Average, BatchNormalization, Embedding,
    SimpleRNN, AveragePooling1D, AveragePooling2D,
    Concatenate, Conv1D, Conv2D, Cropping1D, Dense, Dropout, Flatten,
    GlobalAveragePooling1D, GlobalAveragePooling2D,
    GlobalAveragePooling3D, GlobalMaxPooling1D, GlobalMaxPooling2D,
    GlobalMaxPooling3D, LocallyConnected1D, MaxPooling1D, MaxPooling2D,
    Maximum, Minimum, Multiply, Softmax, Subtract, add, average,
    concatenate, maximum, minimum, multiply, subtract,
)

__all__ = [
    "Model", "Sequential", "LSTM", "GRU", "SimpleRNN", "Embedding",
    "BatchNormalization",
    "Activation", "Add", "Average", "AveragePooling1D",
    "AveragePooling2D", "Concatenate", "Conv1D", "Conv2D", "Cropping1D",
    "Dense", "Dropout", "Flatten", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D",
    "GlobalMaxPooling1D", "GlobalMaxPooling2D", "GlobalMaxPooling3D",
    "LocallyConnected1D", "MaxPooling1D", "MaxPooling2D", "Maximum",
    "Minimum", "Multiply", "Softmax", "Subtract", "add", "average",
    "concatenate", "maximum", "minimum", "multiply", "subtract",
]
