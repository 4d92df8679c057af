"""zamba2-7b [hybrid]: 81L d3584 32H (kv=32, MHA) d_ff=14336 vocab=32000,
Mamba2 backbone (ssm_state=64) + shared attention blocks.
[arXiv:2411.15242; unverified]

Deviations (docs/DESIGN.md §5): the shared attn+MLP block is applied every 9th
layer (pattern length must divide 81); weights are truly shared across
repetitions (read from outside the layer scan).  Long-context serving uses
a 4096-token sliding window on the shared-attn KV (Zamba2's trained context
is 4k) while the Mamba2 state carries unbounded context.
"""
from repro_torch.lm.model import LMConfig
from repro_torch.lm.ssm import SSMConfig

ARCH_ID = "zamba2-7b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        head_dim=112, d_ff=14_336, vocab=32_000,
        pattern=("mamba",) * 8 + ("shared_attn",),
        ssm=SSMConfig(d_state=64, expand=2, headdim=64, chunk=128),
        mlp_kind="swiglu", rope_theta=10_000.0, tie_embeddings=True,
        window=4096,               # shared-attn sliding window (long mode)
        long_context_ok=True,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        pattern=("mamba", "mamba", "shared_attn"),
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, chunk=16),
        mlp_kind="swiglu", tie_embeddings=True, dtype="float32",
        window=64, long_context_ok=True, loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
