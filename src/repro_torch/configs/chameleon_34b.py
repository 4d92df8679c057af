"""chameleon-34b [vlm]: 48L d8192 64H (GQA kv=8) d_ff=22016 vocab=65536,
early-fusion VQ image tokens.  [arXiv:2405.09818; unverified]

Early fusion means image patches arrive as VQ token ids *inside the
vocabulary*, so the backbone consumes plain token ids; the VQ tokenizer
frontend is a stub (input_specs() provides token ids).  QK-norm per the
Chameleon recipe."""
from repro_torch.lm.model import LMConfig

ARCH_ID = "chameleon-34b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=22_016, vocab=65_536,
        pattern=("attn",), qk_norm=True, mlp_kind="swiglu",
        rope_theta=10_000.0, tie_embeddings=False,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab=512, pattern=("attn",), qk_norm=True,
        mlp_kind="swiglu", tie_embeddings=False, dtype="float32",
        loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
