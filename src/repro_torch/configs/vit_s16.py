"""vit-s16 [arXiv:2010.11929]: 224px patch 16, 12L d384 6H d_ff 1536."""
from ..arch import Arch
from ..models import vision
from .shapes import VISION_SHAPES

CONFIG = Arch(
    name="vit-s16",
    family="vit",
    cfg=vision.ViTConfig(
        name="vit-s16", img_res=224, patch=16, n_layers=12, d_model=384, n_heads=6, d_ff=1536
    ),
    shapes=VISION_SHAPES,
    notes="cls_384 re-inits pos-emb at the 384 grid (interpolation equivalent for dry-run).",
)

SMOKE = Arch(
    name="vit-s16-smoke",
    family="vit",
    cfg=vision.ViTConfig(
        name="vit-smoke", img_res=32, patch=8, n_layers=2, d_model=64, n_heads=4, d_ff=128, n_classes=10
    ),
    shapes=VISION_SHAPES,
)
