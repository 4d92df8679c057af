"""seamless-m4t-medium [audio]: enc-dec 12L+12L d1024 16H (MHA kv=16)
d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a STUB per the assignment: ``input_specs()`` feeds
precomputed frame embeddings (B, S, 1024) to the encoder; the decoder is a
standard causal transformer with cross-attention."""
from repro_torch.lm.model import LMConfig

ARCH_ID = "seamless-m4t-medium"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=4096, vocab=256_206,
        pattern=("xattn",), encoder_layers=12,
        mlp_kind="swiglu", rope_theta=10_000.0, tie_embeddings=True,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, pattern=("xattn",), encoder_layers=2,
        mlp_kind="swiglu", tie_embeddings=True, dtype="float32",
        loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
