"""repro_torch.examples: the thin clients of ``examples/`` on one card.

Each module is the port of the reference client of the same name, run as
``python -m repro_torch.examples.<name>``; each runs on the CUDA card
unless given ``--device cpu`` (the kernels' plain versions), and raises
without either.

* ``quickstart``         fractal partition + block-wise FPS and ball query
  on one 4096-point cloud, with recall against the global search
* ``serve_pnn``          a mixed-size request stream through
  ``serve.ServeEngine``
* ``segment_scene``      one room-scale scene through ``scene.SceneEngine``
* ``train_pointnet``     PointNet++ classification training, BPPO or global
  point ops (the paper's accuracy comparison, Fig. 14), with checkpoint
  and restart
* ``lm_pretrain_smoke``  a reduced LM config on a synthetic token stream
  through the fault-tolerant loop

Each has ``main(argv=None) -> dict``: it parses the reference's flags
(``--impl`` and ``--mesh`` dropped: kernels follow the device, and there
is one card), prints the reference's lines and returns the numbers it
printed.  Its body is a function that takes its inputs (weights, points,
batch functions) as arguments.
"""
