"""repro_torch.lm: the LM substrate for the attention block kinds.

* ``layers``    dense, RMSNorm, embedding, RoPE, softcap, MLP
* ``attention`` GQA attention: full/prefill, flash (chunked), decode with
  a KV cache (rolling for local layers)
* ``model``     ``LMConfig``, ``init``, ``forward``, ``lm_loss``,
  ``prefill``, ``decode_step``
"""
