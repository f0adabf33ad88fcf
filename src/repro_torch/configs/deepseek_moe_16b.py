"""deepseek-moe-16b [arXiv:2401.06066]: 28L d2048 16H (kv=16) expert
d_ff=1408, vocab 102400; 2 shared + 64 routed top-6 (fine-grained)."""
from ..arch import Arch
from ..models import layers as L
from ..models import lm
from .shapes import LM_SHAPES

CONFIG = Arch(
    name="deepseek-moe-16b",
    family="lm",
    cfg=lm.LMConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=2816,
        vocab=102400,
        moe=L.MoECfg(
            d_model=2048,
            d_ff_expert=1408,
            n_experts=64,
            top_k=6,
            n_shared=2,
            d_ff_shared=2816,
        ),
    ),
    shapes=LM_SHAPES,
    notes="Fine-grained MoE: 64 routed top-6 + 2 shared experts.",
)

SMOKE = Arch(
    name="deepseek-moe-16b-smoke",
    family="lm",
    cfg=lm.LMConfig(
        name="deepseek-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        remat=False,
        moe=L.MoECfg(d_model=64, d_ff_expert=32, n_experts=8, top_k=6, n_shared=2, d_ff_shared=64),
    ),
    shapes=LM_SHAPES,
)
