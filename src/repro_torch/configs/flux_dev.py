"""flux-dev [BFL tech report; unverified]: MMDiT rectified flow, 19 double +
38 single blocks, d3072 24H, 12B params, img 1024 (latent 128)."""
from ..arch import Arch
from ..models import diffusion
from .shapes import DIFFUSION_SHAPES

CONFIG = Arch(
    name="flux-dev",
    family="flux",
    cfg=diffusion.FluxConfig(name="flux-dev"),
    shapes=DIFFUSION_SHAPES,
    notes="Text stream stubbed as precomputed T5-dim embeddings (modality-stub rule); "
    "2D sincos pos instead of 3D RoPE — documented simplification.",
    # 24 heads % 16 != 0: sharding head_dim instead only buys qkv re-gathers
    # (EXPERIMENTS.md §Perf flux iteration 2) — replicate attention weights
    # (~5.7 GB bf16/dev) and TP the MLPs.
    sharding_overrides={"head_dim": None},
)

SMOKE = Arch(
    name="flux-dev-smoke",
    family="flux",
    cfg=diffusion.FluxConfig(
        name="flux-smoke",
        img_res=64,
        latent_res=8,
        patch=2,
        n_double=2,
        n_single=2,
        d_model=64,
        n_heads=4,
        in_ch=4,
        txt_len=8,
        txt_dim=32,
        vec_dim=16,
        remat=False,
    ),
    shapes=DIFFUSION_SHAPES,
)
