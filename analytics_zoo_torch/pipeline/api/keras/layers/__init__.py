from analytics_zoo_torch.pipeline.api.keras.layers.core import (
    Dense, Dropout, Flatten, Lambda,
)
from analytics_zoo_torch.pipeline.api.keras.layers.conv import (
    AtrousConvolution1D, AtrousConvolution2D, Convolution1D, Convolution2D,
    Convolution3D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.embedding import (
    Embedding, WordEmbedding,
)
from analytics_zoo_torch.pipeline.api.keras.layers.merge import Merge, merge
from analytics_zoo_torch.pipeline.api.keras.layers.normalization import (
    LayerNorm,
)
from analytics_zoo_torch.pipeline.api.keras.layers.pooling import (
    GlobalMaxPooling1D,
)
from analytics_zoo_torch.pipeline.api.keras.layers.recurrent import (
    GRU, LSTM, Bidirectional, SimpleRNN,
)
from analytics_zoo_torch.pipeline.api.keras.layers.attention import (
    MultiHeadSelfAttention, PositionwiseFeedForward, transformer_block,
)

__all__ = ["Dense", "Dropout", "Flatten", "Lambda", "AtrousConvolution1D",
           "AtrousConvolution2D", "Convolution1D", "Convolution2D",
           "Convolution3D", "Embedding", "WordEmbedding", "Merge", "merge",
           "LayerNorm", "GlobalMaxPooling1D", "MultiHeadSelfAttention",
           "PositionwiseFeedForward", "transformer_block", "SimpleRNN", "LSTM",
           "GRU", "Bidirectional"]
