from .attention import AttentionLayer, BasicTransformerBlock, GEGLUFeedForward, TransformerBlock
from .common import (ConvLayer, Dense, Downsample, FourierEmbedding, FusedGroupNormSiLU,
                     ResidualBlock, TimeProjection, Upsample)
from .unet import Unet

__all__ = ["AttentionLayer", "BasicTransformerBlock", "GEGLUFeedForward", "TransformerBlock",
           "ConvLayer", "Dense", "Downsample", "FourierEmbedding", "FusedGroupNormSiLU",
           "ResidualBlock", "TimeProjection", "Upsample", "Unet"]
