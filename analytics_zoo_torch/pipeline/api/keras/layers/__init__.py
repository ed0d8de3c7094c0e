from analytics_zoo_torch.pipeline.api.keras.layers.core import (
    Activation, Dense, Dropout, Flatten, Highway, Lambda, Masking,
    MaxoutDense, Permute, RepeatVector, Reshape, SparseDense,
)
from analytics_zoo_torch.pipeline.api.keras.layers.embedding import (
    Embedding, SparseEmbedding, WordEmbedding,
)
from analytics_zoo_torch.pipeline.api.keras.layers.merge import Merge, merge
from analytics_zoo_torch.pipeline.api.keras.layers.moe import MoE
from analytics_zoo_torch.pipeline.api.keras.layers.normalization import (
    BatchNormalization, L2Normalization, LayerNorm, NormalizeScale,
)
from analytics_zoo_torch.pipeline.api.keras.layers.recurrent import (
    GRU, LSTM, Bidirectional, SimpleRNN,
)
from analytics_zoo_torch.pipeline.api.keras.layers.conv import (
    AtrousConvolution1D, AtrousConvolution2D, Convolution1D,
    Convolution2D, Convolution3D, Cropping1D, Cropping2D, Cropping3D,
    Deconvolution2D, SeparableConvolution2D, ShareConvolution2D,
    SpaceToDepth2D,
    UpSampling1D, UpSampling2D, UpSampling3D,
    ZeroPadding1D, ZeroPadding2D, ZeroPadding3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.pooling import (
    AveragePooling1D, AveragePooling2D, AveragePooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D,
    MaxPooling1D, MaxPooling2D, MaxPooling3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.advanced_activations import (
    ELU, LeakyReLU, PReLU, Softmax, SReLU, ThresholdedReLU,
)
from analytics_zoo_torch.pipeline.api.keras.layers.noise import (
    GaussianDropout, GaussianNoise, SpatialDropout1D, SpatialDropout2D,
    SpatialDropout3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.wrappers import (
    KerasLayerWrapper, TimeDistributed,
)
from analytics_zoo_torch.pipeline.api.keras.layers.convlstm import (
    ConvLSTM2D, ConvLSTM3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.elementwise import (
    AddConstant, BinaryThreshold, CAdd, CMul, Exp, GaussianSampler,
    HardShrink, HardTanh, Identity, Log, LRN2D, Mul, MulConstant,
    Negative, Power, ResizeBilinear, RReLU, Scale, SoftShrink, Sqrt,
    Square, Threshold, WithinChannelLRN2D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.shape_ops import (
    Expand, ExpandDim, GetShape, Max, Narrow, Select, SelectTable,
    SplitTensor, Squeeze,
)
from analytics_zoo_torch.pipeline.api.keras.layers.local import (
    LocallyConnected1D, LocallyConnected2D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.attention import (
    BERT, MultiHeadSelfAttention, PositionwiseFeedForward,
    TransformerLayer, transformer_block,
)

# Keras-2 style aliases
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D

__all__ = [
    "Activation", "Dense", "Dropout", "Flatten", "Highway", "Lambda",
    "Masking", "MaxoutDense", "Permute", "RepeatVector", "Reshape",
    "SparseDense", "Embedding", "WordEmbedding", "Merge", "merge",
    "BatchNormalization", "L2Normalization", "LayerNorm",
    "NormalizeScale",
    "GRU", "LSTM", "Bidirectional", "SimpleRNN",
    "AtrousConvolution2D", "Convolution1D", "Convolution2D",
    "Convolution3D", "Conv1D", "Conv2D", "Conv3D",
    "Cropping1D", "Cropping2D", "Cropping3D", "Deconvolution2D",
    "SeparableConvolution2D", "UpSampling1D", "UpSampling2D",
    "UpSampling3D", "ZeroPadding1D", "ZeroPadding2D", "ZeroPadding3D",
    "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
    "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalAveragePooling3D", "GlobalMaxPooling1D", "GlobalMaxPooling2D",
    "GlobalMaxPooling3D", "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
    "ELU", "LeakyReLU", "PReLU", "Softmax", "SReLU", "ThresholdedReLU",
    "GaussianDropout", "GaussianNoise", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D",
    "KerasLayerWrapper", "TimeDistributed",
    "ConvLSTM2D", "ConvLSTM3D", "LocallyConnected1D",
    "LocallyConnected2D",
    "BERT", "MultiHeadSelfAttention", "PositionwiseFeedForward",
    "TransformerLayer", "transformer_block",
    "SparseEmbedding", "AtrousConvolution1D", "ShareConvolution2D",
    "SpaceToDepth2D", "MoE",
    "AddConstant", "BinaryThreshold", "CAdd", "CMul", "Exp",
    "GaussianSampler", "HardShrink", "HardTanh", "Identity", "Log",
    "LRN2D", "Mul", "MulConstant", "Negative", "Power",
    "ResizeBilinear", "RReLU", "Scale", "SoftShrink", "Sqrt", "Square",
    "Threshold", "WithinChannelLRN2D",
    "Expand", "ExpandDim", "GetShape", "Max", "Narrow", "Select",
    "SelectTable", "SplitTensor", "Squeeze",
]
