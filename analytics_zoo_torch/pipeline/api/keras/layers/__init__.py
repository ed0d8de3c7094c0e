from analytics_zoo_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Dropout, Flatten, Lambda,
)
from analytics_zoo_torch.pipeline.api.keras.layers.conv import (
    AtrousConvolution1D, AtrousConvolution2D, Convolution1D, Convolution2D,
    Convolution3D, SpaceToDepth2D, ZeroPadding1D, ZeroPadding2D,
    ZeroPadding3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.embedding import (
    Embedding, WordEmbedding,
)
from analytics_zoo_torch.pipeline.api.keras.layers.merge import Merge, merge
from analytics_zoo_torch.pipeline.api.keras.layers.normalization import (
    BatchNormalization, LayerNorm,
)
from analytics_zoo_torch.pipeline.api.keras.layers.pooling import (
    AveragePooling1D, AveragePooling2D, AveragePooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D,
    MaxPooling1D, MaxPooling2D, MaxPooling3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.recurrent import (
    GRU, LSTM, Bidirectional, SimpleRNN,
)
from analytics_zoo_torch.pipeline.api.keras.layers.attention import (
    BERT, MultiHeadSelfAttention, PositionwiseFeedForward, TransformerLayer,
    transformer_block,
)
from analytics_zoo_torch.pipeline.api.keras.layers.wrappers import (
    KerasLayerWrapper, TimeDistributed,
)

# Keras-2 style aliases
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D

__all__ = ["Activation", "Dense", "Dropout", "Flatten", "Lambda",
           "AtrousConvolution1D", "AtrousConvolution2D", "Convolution1D",
           "Convolution2D", "Convolution3D", "Conv1D", "Conv2D", "Conv3D",
           "SpaceToDepth2D", "ZeroPadding1D", "ZeroPadding2D",
           "ZeroPadding3D", "Embedding", "WordEmbedding", "Merge", "merge",
           "BatchNormalization", "LayerNorm",
           "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D",
           "GlobalAveragePooling3D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "GlobalMaxPooling3D", "MaxPooling1D",
           "MaxPooling2D", "MaxPooling3D", "MultiHeadSelfAttention",
           "PositionwiseFeedForward", "transformer_block", "BERT",
           "TransformerLayer", "TimeDistributed", "KerasLayerWrapper",
           "SimpleRNN", "LSTM", "GRU", "Bidirectional"]
