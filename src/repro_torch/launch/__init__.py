"""repro_torch.launch: the cells and launchers of ``repro.launch`` on one
card.

* ``pnn_cell``  run a serving or fine-tune step at S3DIS scale (33K / 289K
  / 1M points) and report its time, peak memory and roofline row
* ``roofline``  the roofline terms, with the H100's rates, and the LM
  estimators ``count_params``, ``active_params``, ``model_flops_for``
* ``dryrun``    run the LM (arch x shape) cells and the PNN cells, and
  print their roofline table
* ``perf``      re-run a cell under the reference's variants that change
  what one card computes
* ``serve``     LM serving: prefill + greedy decode of a reduced config
* ``train``     LM training: the train step of ``lm.steps`` in the
  fault-tolerant loop, checkpoints in the reference's layout

The TPU pod meshes of ``launch/mesh.py`` have no counterpart on one card.
"""
