"""squeezenet [arXiv:1602.07360] — the paper's own compact model (FastVA
Table II pairs it with ResNet-50 as the fast/low-accuracy option)."""
from ..arch import Arch
from ..models import convnets
from .shapes import VISION_SHAPES

CONFIG = Arch(
    name="squeezenet",
    family="squeezenet",
    cfg=convnets.SqueezeNetConfig(name="squeezenet"),
    shapes=VISION_SHAPES,
)

SMOKE = Arch(
    name="squeezenet-smoke",
    family="squeezenet",
    cfg=convnets.SqueezeNetConfig(name="squeezenet-smoke", n_classes=10),
    shapes=VISION_SHAPES,
)
