"""repro_torch.launch: the cells and launchers of ``repro.launch``.

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

* ``mesh``      ``make_host_mesh``: the (data, model) mesh over the cards
  of one host, one process a card under torchrun (the reference's TPU pod
  meshes have no counterpart)
* ``mesh_smoke``  the multi-card PNN path checked end to end under
  torchrun (``chip_smoke.py`` phase 17)
"""
