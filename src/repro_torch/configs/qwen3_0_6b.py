"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B]: 28L d1024 16H (kv=8, head_dim=128)
d_ff=3072, vocab 151936, qk-norm."""
from ..arch import Arch
from ..models import lm
from .shapes import LM_SHAPES

CONFIG = Arch(
    name="qwen3-0.6b",
    family="lm",
    cfg=lm.LMConfig(
        name="qwen3-0.6b",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
    ),
    shapes=LM_SHAPES,
    notes="Dense GQA with qk-norm; kv=8 heads replicate over the 16-way model axis "
    "(head_dim shards instead via the reuse-guarded rules).",
)

SMOKE = Arch(
    name="qwen3-0.6b-smoke",
    family="lm",
    cfg=lm.LMConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        qk_norm=True,
        remat=False,
    ),
    shapes=LM_SHAPES,
)
