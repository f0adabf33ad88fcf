"""resnet-50 [arXiv:1512.03385]: depths 3-4-6-3, width 64, bottleneck x4.
Also the paper's own accurate model (FastVA Table II)."""
from ..arch import Arch
from ..models import convnets
from .shapes import VISION_SHAPES

CONFIG = Arch(
    name="resnet-50",
    family="resnet",
    cfg=convnets.ResNetConfig(name="resnet-50"),
    shapes=VISION_SHAPES,
)

SMOKE = Arch(
    name="resnet-50-smoke",
    family="resnet",
    cfg=convnets.ResNetConfig(name="resnet-smoke", depths=(1, 1), width=8, n_classes=10),
    shapes=VISION_SHAPES,
)
