"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H (kv=16) expert
d_ff=1408, vocab 151936; 4 shared + 60 routed top-4.

EP note: 60 routed experts are padded to 64 so the expert dim shards over the
16-way model axis (the 4 pad experts get ~zero router mass; recorded in
DESIGN.md §Arch-applicability).
"""
from ..arch import Arch
from ..models import layers as L
from ..models import lm
from .shapes import LM_SHAPES

CONFIG = Arch(
    name="qwen2-moe-a2.7b",
    family="lm",
    cfg=lm.LMConfig(
        name="qwen2-moe-a2.7b",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=5632,
        vocab=151936,
        moe=L.MoECfg(
            d_model=2048,
            d_ff_expert=1408,
            n_experts=64,  # 60 routed + 4 pad (EP divisibility)
            top_k=4,
            n_shared=4,
            d_ff_shared=5632,
        ),
    ),
    shapes=LM_SHAPES,
    notes="MoE 60e top-4 padded to 64 for EP; 4 shared experts as dense SwiGLU.",
)

SMOKE = Arch(
    name="qwen2-moe-a2.7b-smoke",
    family="lm",
    cfg=lm.LMConfig(
        name="qwen2-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        remat=False,
        moe=L.MoECfg(d_model=64, d_ff_expert=32, n_experts=8, top_k=4, n_shared=2, d_ff_shared=128),
    ),
    shapes=LM_SHAPES,
)
