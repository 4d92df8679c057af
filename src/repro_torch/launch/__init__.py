"""repro_torch.launch: the PNN cells of ``repro.launch`` on one card.

* ``pnn_cell``  run a serving or fine-tune step at S3DIS scale (33K / 289K
  / 1M points) and report its time, peak memory and roofline row
* ``roofline``  the roofline terms, with the H100's rates
* ``dryrun``    the command line over the cells
* ``serve``     LM serving: prefill + greedy decode of a reduced config

The other LM launchers (``train``, the LM cells of ``dryrun`` and
``perf``) wait for ROADMAP.md A6c/A7; the TPU pod meshes of
``launch/mesh.py`` have no counterpart on one card.
"""
