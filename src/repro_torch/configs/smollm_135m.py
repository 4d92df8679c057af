"""smollm-135m [dense]: 30L d576 9H (GQA kv=3) d_ff=1536 vocab=49152,
llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.lm.model import LMConfig

ARCH_ID = "smollm-135m"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        head_dim=64, d_ff=1536, vocab=49_152,
        pattern=("attn",), mlp_kind="swiglu",
        rope_theta=10_000.0, tie_embeddings=True,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab=512, pattern=("attn",), mlp_kind="swiglu",
        tie_embeddings=True, dtype="float32", loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
