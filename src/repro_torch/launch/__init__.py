"""repro_torch.launch: the PNN cells of ``repro.launch`` on one card.

* ``pnn_cell``  run a serving or fine-tune step at S3DIS scale (33K / 289K
  / 1M points) and report its time, peak memory and roofline row
* ``roofline``  the roofline terms, with the H100's rates
* ``dryrun``    the command line over the cells

The LM cells (``train``, ``serve``, the LM part of ``dryrun`` and ``perf``)
wait for the port of ``lm/``; the TPU pod meshes of ``launch/mesh.py`` have
no counterpart on one card.
"""
