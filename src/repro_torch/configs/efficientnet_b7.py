"""efficientnet-b7 [arXiv:1905.11946]: width 2.0, depth 3.1 (B0 base)."""
from ..arch import Arch
from ..models import convnets
from .shapes import VISION_SHAPES

CONFIG = Arch(
    name="efficientnet-b7",
    family="effnet",
    cfg=convnets.EfficientNetConfig(name="efficientnet-b7", width_mult=2.0, depth_mult=3.1),
    shapes=VISION_SHAPES,
)

SMOKE = Arch(
    name="efficientnet-b7-smoke",
    family="effnet",
    cfg=convnets.EfficientNetConfig(name="effnet-smoke", width_mult=0.25, depth_mult=0.34, n_classes=10),
    shapes=VISION_SHAPES,
)
