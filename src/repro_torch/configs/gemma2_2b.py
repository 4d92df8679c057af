"""gemma2-2b [dense]: 26L d2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local+global alternating (window 4096), attn+final logit softcap,
sandwich norms, GeGLU.  [arXiv:2408.00118; hf]"""
from repro_torch.lm.model import LMConfig

ARCH_ID = "gemma2-2b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=9216, vocab=256_000,
        pattern=("local", "attn"), window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=256 ** -0.5,          # query_pre_attn_scalar
        post_norm=True, emb_scale=True, mlp_kind="geglu",
        rope_theta=10_000.0, tie_embeddings=True,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, pattern=("local", "attn"), window=16,
        attn_softcap=50.0, final_softcap=30.0, attn_scale=16 ** -0.5,
        post_norm=True, emb_scale=True, mlp_kind="geglu",
        tie_embeddings=True, dtype="float32", loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
