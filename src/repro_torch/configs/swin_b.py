"""swin-b [arXiv:2103.14030]: 224px patch 4 window 7, depths 2-2-18-2,
dims 128-256-512-1024."""
from ..arch import Arch
from ..models import vision
from .shapes import VISION_SHAPES

CONFIG = Arch(
    name="swin-b",
    family="swin",
    cfg=vision.SwinConfig(name="swin-b", img_res=224),
    shapes=VISION_SHAPES,
    notes="cls_384 uses window 12 (as Swin-B-384 does) via per-shape cfg override.",
)

SMOKE = Arch(
    name="swin-b-smoke",
    family="swin",
    cfg=vision.SwinConfig(
        name="swin-smoke",
        img_res=32,
        patch=4,
        window=4,
        depths=(2, 2),
        dims=(32, 64),
        n_heads=(2, 4),
        n_classes=10,
    ),
    shapes=VISION_SHAPES,
)
