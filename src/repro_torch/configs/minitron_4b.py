"""minitron-4b [dense]: 32L d3072 24H (GQA kv=8) d_ff=9216 vocab=256000,
pruned nemotron (squared-ReLU MLP).  [arXiv:2407.14679; hf]"""
from repro_torch.lm.model import LMConfig

ARCH_ID = "minitron-4b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        head_dim=128, d_ff=9216, vocab=256_000,
        pattern=("attn",), mlp_kind="relu2",
        rope_theta=10_000.0, tie_embeddings=False,
        long_context_ok=False,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, pattern=("attn",), mlp_kind="relu2",
        tie_embeddings=False, dtype="float32", loss_chunk=64,
    )
    base.update(kw)
    return LMConfig(**base)
