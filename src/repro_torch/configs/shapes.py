"""Assigned input-shape sets per family (verbatim from the assignment)."""
from ..arch import ShapeSpec

LM_SHAPES = (
    ShapeSpec("train_4k", "train", batch=256, seq=4096),
    ShapeSpec("prefill_32k", "prefill", batch=32, seq=32768),
    ShapeSpec("decode_32k", "decode", batch=128, seq=32768),
    # decode against a 512k cache: one token, linear in cache length, so it is
    # runnable for full-attention archs with a sequence-sharded KV (DESIGN §4).
    ShapeSpec("long_500k", "decode", batch=1, seq=524288),
)

DIFFUSION_SHAPES = (
    ShapeSpec("train_256", "denoise_train", batch=256, img=256, steps=1000),
    ShapeSpec("gen_1024", "denoise_step", batch=4, img=1024, steps=50),
    ShapeSpec("gen_fast", "denoise_step", batch=16, img=512, steps=4),
    ShapeSpec("train_1024", "denoise_train", batch=32, img=1024, steps=1000),
)

VISION_SHAPES = (
    ShapeSpec("cls_224", "classify_train", batch=256, img=224),
    ShapeSpec("cls_384", "classify_train", batch=64, img=384),
    ShapeSpec("serve_b1", "classify_serve", batch=1, img=224),
    ShapeSpec("serve_b128", "classify_serve", batch=128, img=224),
)
