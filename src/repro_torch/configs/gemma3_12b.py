"""gemma3-12b [dense]: 48L d3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global (window 1024), QK-norm, 128k context.
[hf:google/gemma-3-*; unverified]

Deviation: one rope_theta is used for both local and global layers (the
reference uses 10k local / 1M global)."""
from repro_torch.lm.model import LMConfig

ARCH_ID = "gemma3-12b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
        head_dim=256, d_ff=15_360, vocab=262_144,
        pattern=("local",) * 5 + ("attn",), window=1024,
        qk_norm=True, emb_scale=True, mlp_kind="geglu",
        rope_theta=1_000_000.0, tie_embeddings=True,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, pattern=("local",) * 5 + ("attn",), window=16,
        qk_norm=True, emb_scale=True, mlp_kind="geglu",
        tie_embeddings=True, dtype="float32", loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
