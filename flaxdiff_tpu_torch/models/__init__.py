from .attention import AttentionLayer, BasicTransformerBlock, GEGLUFeedForward, TransformerBlock
from .common import (ConvLayer, Dense, Downsample, FourierEmbedding, FusedGroupNormSiLU,
                     GroupNorm, ResidualBlock, RMSNorm, TimeProjection, Upsample)
from .dit import DiTBlock, SimpleDiT
from .mmdit import (HierarchicalMMDiT, MMAdaLNZero, MMDiTBlock, PatchExpanding, PatchMerging,
                    SimpleMMDiT)
from .ssm import (BidirectionalS5Layer, HybridSSMAttentionDiT, S5Layer, SpatialFusionConv,
                  SSMDiTBlock, build_block_pattern)
from .unet import Unet
from .uvit import SimpleUDiT, UViT
from .vit_common import (AdaLNParams, AdaLNZero, PatchEmbedding, PositionalEncoding,
                         RoPEAttention, ScanPatchEmbed, TimeTextEmbedding)

__all__ = ["AttentionLayer", "BasicTransformerBlock", "GEGLUFeedForward", "TransformerBlock",
           "ConvLayer", "Dense", "Downsample", "FourierEmbedding", "FusedGroupNormSiLU",
           "GroupNorm", "ResidualBlock", "RMSNorm", "TimeProjection", "Upsample", "Unet",
           "AdaLNParams", "AdaLNZero", "DiTBlock", "PatchEmbedding", "PositionalEncoding",
           "RoPEAttention", "ScanPatchEmbed", "SimpleDiT", "TimeTextEmbedding",
           "HierarchicalMMDiT", "MMAdaLNZero", "MMDiTBlock", "PatchExpanding", "PatchMerging",
           "SimpleMMDiT", "BidirectionalS5Layer", "HybridSSMAttentionDiT", "S5Layer",
           "SpatialFusionConv", "SSMDiTBlock", "build_block_pattern", "SimpleUDiT", "UViT"]
