"""repro_torch.lm: the LM substrate, every block kind of the ten
architectures.

* ``layers``    dense, RMSNorm, embedding, RoPE, softcap, MLP
* ``attention`` GQA attention: full/prefill, flash (chunked), decode with
  a KV cache (rolling for local and shared-attention layers)
* ``moe``       mixture of experts with sort-based (dropping) dispatch
* ``ssm``       Mamba2 (SSD): chunked prefill, recurrent decode
* ``xlstm``     mLSTM (chunked prefill, recurrent decode) and sLSTM
* ``model``     ``LMConfig``, ``init``, ``forward``, ``lm_loss``,
  ``prefill``, ``decode_step``
"""
