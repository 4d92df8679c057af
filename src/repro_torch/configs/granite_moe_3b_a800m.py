"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) moe_ff=512
vocab=49155, 40 experts top-8.  [hf:ibm-granite/granite-3.0-*-base]"""
from repro_torch.lm.model import LMConfig, MoEOpts

ARCH_ID = "granite-moe-3b-a800m"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        head_dim=64, d_ff=512, vocab=49_155,
        pattern=("moe",),
        moe=MoEOpts(num_experts=40, top_k=8, d_ff_expert=512,
                    router_act="softmax", capacity_factor=1.25),
        mlp_kind="swiglu", rope_theta=10_000.0, tie_embeddings=True,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512, pattern=("moe",),
        moe=MoEOpts(num_experts=8, top_k=2, d_ff_expert=64,
                    router_act="softmax", capacity_factor=8.0),
        mlp_kind="swiglu", tie_embeddings=True, dtype="float32",
        loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
