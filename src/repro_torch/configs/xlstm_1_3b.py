"""xlstm-1.3b [ssm]: 48L d2048 4H vocab=50304, sLSTM + mLSTM blocks (7:1),
d_ff=0 (blocks carry their own projections).  [arXiv:2405.04517; unverified]
"""
from repro_torch.lm.model import LMConfig
from repro_torch.lm.xlstm import XLSTMConfig

ARCH_ID = "xlstm-1.3b"


def config(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID,
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        head_dim=512, d_ff=0, vocab=50_304,
        pattern=("mlstm",) * 7 + ("slstm",),
        xlstm=XLSTMConfig(n_heads=4, proj_factor=2.0, chunk=64),
        tie_embeddings=True, long_context_ok=True,
    )
    base.update(kw)
    return LMConfig(**base)


def reduced(**kw) -> LMConfig:
    base = dict(
        name=ARCH_ID + "-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=0, vocab=512, pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        xlstm=XLSTMConfig(n_heads=4, proj_factor=2.0, chunk=8),
        tie_embeddings=True, dtype="float32", loss_chunk=64,
        long_context_ok=True,
    )
    base.update(kw)
    return LMConfig(**base)
