from .attention import AttentionLayer, BasicTransformerBlock, GEGLUFeedForward, TransformerBlock
from .common import (ConvLayer, Dense, Downsample, FourierEmbedding, FusedGroupNormSiLU,
                     ResidualBlock, TimeProjection, Upsample)
from .dit import DiTBlock, SimpleDiT
from .unet import Unet
from .vit_common import (AdaLNParams, AdaLNZero, PatchEmbedding, PositionalEncoding,
                         RoPEAttention, ScanPatchEmbed, TimeTextEmbedding)

__all__ = ["AttentionLayer", "BasicTransformerBlock", "GEGLUFeedForward", "TransformerBlock",
           "ConvLayer", "Dense", "Downsample", "FourierEmbedding", "FusedGroupNormSiLU",
           "ResidualBlock", "TimeProjection", "Upsample", "Unet", "AdaLNParams", "AdaLNZero",
           "DiTBlock", "PatchEmbedding", "PositionalEncoding", "RoPEAttention",
           "ScanPatchEmbed", "SimpleDiT", "TimeTextEmbedding"]
