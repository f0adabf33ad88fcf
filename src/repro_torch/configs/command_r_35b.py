"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified]: 40L d8192
64H (kv=8) d_ff=22528, vocab 256000, GQA, no-bias."""
from ..arch import Arch
from ..models import lm
from .shapes import LM_SHAPES

CONFIG = Arch(
    name="command-r-35b",
    family="lm",
    cfg=lm.LMConfig(
        name="command-r-35b",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        vocab=256000,
        seq_shard_acts=True,
    ),
    shapes=LM_SHAPES,
    notes="Dense 35B; trains with FSDP(data) x TP(model) + Megatron-SP activation "
    "sharding; sequential (not parallel) block residual — documented deviation.",
)

SMOKE = Arch(
    name="command-r-35b-smoke",
    family="lm",
    cfg=lm.LMConfig(
        name="command-r-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=192,
        vocab=512,
        remat=False,
    ),
    shapes=LM_SHAPES,
)
