"""llama4-scout-17b-16e [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, 16 experts top-1 + shared expert each layer (early fusion).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.lm.model import LMConfig, MoEOpts

ARCH_ID = "llama4-scout-17b-16e"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab=202_048,
        pattern=("moe",),
        moe=MoEOpts(num_experts=16, top_k=1, d_ff_expert=8192,
                    shared_ff=8192, router_act="sigmoid",
                    capacity_factor=1.25),
        mlp_kind="swiglu", rope_theta=500_000.0, tie_embeddings=False,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab=512, pattern=("moe",),
        moe=MoEOpts(num_experts=4, top_k=1, d_ff_expert=96, shared_ff=96,
                    router_act="sigmoid", capacity_factor=4.0),
        mlp_kind="swiglu", tie_embeddings=False, dtype="float32",
        loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
