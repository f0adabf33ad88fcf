"""dit-xl2 [arXiv:2212.09748]: img 256, patch 2 (on /8 VAE latents), 28L
d1152 16H."""
from ..arch import Arch
from ..models import diffusion
from .shapes import DIFFUSION_SHAPES

CONFIG = Arch(
    name="dit-xl2",
    family="dit",
    cfg=diffusion.DiTConfig(
        name="dit-xl2", img_res=256, patch=2, n_layers=28, d_model=1152, n_heads=16, remat=True
    ),
    shapes=DIFFUSION_SHAPES,
    notes="adaLN-Zero DiT; gen shapes use larger latents (pos-emb is sincos, computed per shape).",
)

SMOKE = Arch(
    name="dit-xl2-smoke",
    family="dit",
    cfg=diffusion.DiTConfig(
        name="dit-smoke", img_res=64, patch=2, n_layers=2, d_model=64, n_heads=4, remat=False
    ),
    shapes=DIFFUSION_SHAPES,
)
