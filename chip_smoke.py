#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It drives the paths of the port -- serving, training, the
global (O(n^2)) point ops and room-scale scene segmentation.  Phases, each
of which raises on failure:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the float32 matmul settings (TF32 off, "highest");
2. build every kernel of ``src/repro_torch/kernels/csrc`` with nvcc; then
   ``repro_torch.analysis``: the port's tree lints clean under --strict,
   the interface matrix is clean on the card (each public op's specs
   chunked and not, card against CPU, and against its plain version), and
   every launch of the matrix and of the paths' largest shapes fits the
   card (whole warps within the function's thread limit, grid within the
   device's, shared memory within the opt-in limit, no spills), read from
   the launchers' own geometry; one line a kernel variant (registers,
   local bytes, shared memory, threads, CTAs an SM); any finding fails;
3. hold each hand-written kernel against its plain PyTorch version on the
   same CUDA tensors, by the rules of ``repro_torch.kernels.checks``: on
   its odd ladder (block sizes 65/200/33, empty blocks, all-invalid masks,
   FPS exhaustion, out-of-range gathers; FPS at every variant's edges,
   1-512 lanes for one warp a block, 513-8192 for one CTA, 8193-20,000
   with a scratch row, with one or two valid lanes, valid lanes only in
   each thread's last slot, k=1 and duplicated lattice points; 1500-lane
   windows; ball query and kNN on scattered masks, 1-15 valid lanes at
   num=16, num/k of 1/3/16/40, windows of 8,192 and 20,000 lanes and
   duplicated lattice points, exactly; FPS, ball query, kNN and gather
   chunked through ``kernels.ops`` with a short last chunk (7 blocks by 3,
   1100 by 512); scatter-adds over 33/128/200-row
   windows with out-of-range, duplicate and chunked rows; partition levels
   under all three (da, db) pairs, split values beyond the extents, lanes
   at the split value, blocks of 32-2048 lanes valid only in each thread's
   last slot, chunked runs; the FP blend, ``interp_blend``, over odd and
   float4 widths, overflowing leaves, slots with no leaf, rows outside
   ``out``, a misaligned ``out``, NaN in every padded lane and a chunked
   run) and on the inputs the serving path gives the
   five forward kernels in one microbatch of the largest bucket, with the
   kernel's, the plain version's and the PyTorch library call's median
   times; ``fractal_level_blocks``, on no path, is held and timed on that
   microbatch's stage-0 leaf blocks, each split at its valid midpoint; the
   partition's level pass (``partition``) is held field by field against
   its tensor pass and timed (device, host a call, launches a call, bound
   in bytes) on a blocks microbatch (4 x 4096, a dim0 a cloud) and a rooms
   microbatch (8 x 289,000); its launches in the printed row are the
   serving run's (phase 4), which fails if it launched none; then
   PointNeXt-XL (``pnn.pointnext_xl_seg``: variant pointnext_invres at
   its published widths, 15 InvResMLP blocks, BPPO at th=256, seeded
   random weights): one microbatch of 4 rooms of 289,000 points served
   through ``ServeEngine``, with every kernel's launch count read around
   it (each point-op kernel and the partition launched, one neighbour
   search a stage, one ``local_aggregate`` a block, one ``interp_blend``
   an FP stage), and every kernel call of it (the blocks' stride-1 ball
   queries, 256 centres a leaf block over 512 lanes, and their pooled local
   aggregations, beside the unfused take + cat + addmm + ReLU + pool they
   replace, among them) held and timed as above; then Point Transformer
   (``pnn.point_transformer_seg``: published widths, 18 blocks, BPPO at
   th=256, seeded random weights) the same way on a microbatch of 2 rooms:
   each kernel launched exactly as its structure asks (one stride-1 kNN a
   level, one FPS and kNN a TransitionDown, one 3-NN kNN, gather and
   blend a TransitionUp, one ``vector_attention`` a block, nothing else
   but the partition), 5 searches and 18 blocks counted, the peak device
   memory logged, and every kernel call (the five stride-1 kNN searches,
   256 queries a leaf block over 512 lanes at k 8 and 16, and the 18
   attention layers, beside the PyTorch sequence they replace, among them)
   held and timed; then the FP stages' blend
   alone at level 0 of the XL cell's and the rooms cell's microbatches (4
   rooms at 128 channels, 8 at 64, each room's 9,916 leaf blocks of the
   partition the path makes), held, timed beside the multiply, ``sum`` and
   ``scatter_`` it replaced, and compared with that sequence's rows bit for
   bit;
4. serve 8 mixed-size segmentation requests through ``ServeEngine`` on the
   card (pointnet2 seg, full widths, th=256, buckets 4096/16384/65536,
   microbatch 4, seeded random weights), with every kernel's launch count
   read around that run; check the logits, and hold the 4096-bucket ones
   against the same engine on the CPU;
5. one 289,000-point cloud (S3DIS scale) through ``pnn.apply``: its time
   and peak device memory;
6. one microbatch per bucket under ``torch.profiler``: device time by
   kernel and the card's idle share;
7. training (``repro_torch.train.pnn``, pointnet2 seg at full widths,
   th=256): the first step's loss and every parameter's gradient on the
   card against the CPU, for one 4096-point cloud and for the 8 x 16384
   batch of the run; then 20 AdamW steps at 8 x 16384 points through
   ``fit``, with every kernel's launch count read around them, the
   losses, the median step time and the peak device memory;
8. the kernels on one training step's own inputs (the gather's backward,
   ``scatter_add_blocks``, on that step's cotangents), held and timed as
   in phase 3, and that step under ``torch.profiler``;
9. the global point ops (``point_ops="global"``, plain tensor ops, no
   plan): one microbatch of 4 x 16384 clouds through a global
   ``ServeEngine`` beside the BPPO engine on the same clouds, and the
   4096-bucket logits held against the same global engine on the CPU;
10. scene segmentation (``repro_torch.scene``) at the configuration of
   examples/segment_scene.py (pointnet2 seg, full widths, th=256,
   tile_points=4096, halo=0.15, microbatch 4): a 16,384-point scene on
   the card against the CPU (same tiling, logits by the serving rule),
   then a 1,000,000-point scene from the port's generator, made on the
   card, with every kernel's launch count read around its inference: each
   point owned by exactly one tile, finite logits, the times to generate,
   tile and infer, and the peak device memory;
11. training with gradient compression: ``fit`` as in phase 7 with the
   int8 and then the bf16 codec (error feedback), each with its launch
   counts, losses and median step beside the uncompressed one;
12. the PNN cells of ``repro_torch.launch.pnn_cell`` (``CELLS``):
   PointNeXt serving at 289k points (the largest batch that fits), a
   PointNeXt fine-tune step at 33k points, PointVector serving at 289k
   points and PointNeXt serving at 1M points (batch 1), each with its
   launch counts over its timed steps, step time, peak memory and
   roofline row, and every kernel call of one of its steps (each leaf
   chunk, the short last one included) held against its plain version on
   that call's own inputs; one step of the first under
   ``torch.profiler``; then PointNeXt and PointVector logits at 4096
   points on the card against the CPU;
13. the first training step's decompressed gradients of each codec, on
   the card against the CPU (one 4096-point cloud), and the codec on the
   card against the CPU on the same gradients, bit for bit;
14. LM serving (``repro_torch.lm``, no hand-written kernel: the LM path of
   the reference has no TPU kernel): each of the ten architectures at
   its published widths (``config()``), one repetition of its block
   pattern deep (seamless: one encoder layer; zamba2: 8 Mamba2 layers and
   the shared attention; xlstm: 7 mLSTM and 1 sLSTM), in float32 with
   seeded random weights, prefill of a 2 x 32 prompt and 4 teacher-forced
   decode steps on the card against the CPU by the serving rule;
   gemma2-2b and zamba2-7b so again at a 1 x 4200 prompt (the chunked
   attention, a wrapped 4096-slot rolling cache; 33 SSD chunks, the last
   padded) and xlstm-1.3b at 1 x 200 (4 mLSTM chunks, the last padded;
   200 sLSTM steps); smollm-135m and granite-moe-3b-a800m at full config
   in bfloat16, card against CPU, within twice the CPU's own bfloat16 vs
   float32 gap, with the number of (token, slot) MoE routes that differ;
   then at full width (bfloat16 activations, float32 weights) through
   the launcher's greedy loop under the one-card mesh's logical rules:
   smollm-135m (batch 8, prompt 512, 64 new tokens), gemma2-2b (batch 1,
   prompt 8192, 32 new: the chunked attention in every layer, both
   softcaps, the 4096-slot rolling caches past their wrap),
   granite-moe-3b-a800m (8 x 512 + 64), llama4-scout-17b-16e (8 x 512 +
   64, 4 of its 48 layers: the whole model's weights do not fit one
   card), zamba2-7b (1 x 8192 + 32: 64 SSD chunks, the shared attention
   past its window) and xlstm-1.3b (4 x 1024 + 64), each at full depth
   but llama4: prefill time, each decode step, tokens/s, peak device
   memory, finite logits, and one more decode step under
   ``torch.profiler`` (device ops, device busy time; idle share against
   the unprofiled median step);
15. LM training (``repro_torch.lm.steps``, ``launch.train``, the LM cells
   of ``launch.dryrun``; no hand-written kernel): the first step's
   gradients of smollm-135m, gemma2-2b, seamless-m4t-medium,
   granite-moe-3b-a800m, zamba2-7b and xlstm-1.3b (every block kind; one
   repetition of the pattern at published widths, float32, 1 x 64 tokens)
   on the card against the CPU by ``checks.hold_grads`` (a parameter all
   zero on the CPU all zero on the card); then ``launch.train``'s entry
   point for smollm-135m at full config, 8 x 4096 tokens in 8
   microbatches, 20 steps (a falling loss; median step, tokens/s, peak
   memory, usefulness and model-flops share of the bfloat16 peak, one
   step under ``torch.profiler``), a checkpointed run to 10 steps and its
   rerun to 12 (a resume at step 10), 5 steps with int8 compression; and
   four LM cells through ``launch.dryrun.run_cell``: smollm-135m x
   train_4k, prefill_32k (batch 1) and decode_32k, zamba2-7b x long_500k,
   each row with its cuts;
16. (run right after phase 10) the thin clients of
   ``repro_torch.examples``, each through its ``main`` on the card, each
   returned dict one JSON line, with every kernel's launches around each
   client: quickstart as the reference runs it, its integers equal to
   its own run on the CPU, mean count and recall within 1e-6; serve_pnn,
   24 requests of PointNeXt at its published widths through buckets
   4096/16384/65536 (microbatch 4, th=256): every answer of its shape,
   one build per plan-cache key, the four serving kernels launched;
   segment_scene at 289,000 points (tile_points 16384): each point owned
   once, finite logits, points/s and peak device memory; train_pointnet,
   300 steps of 16 x 1024 points (th=64) with BPPO and with the global
   ops (finite losses, the mean of the last 5 logged losses below the
   first 5), then the BPPO run again on its checkpoint (resumed at step
   300, the same final accuracy), and both accuracies with their gap
   beside the paper's < 0.7 % (not gated: 128 eval clouds); the LM smoke
   (smollm-135m reduced, 60 steps, int8): finite losses, each within
   1e-3 of the same client's run on the CPU, and its rerun (resumed at
   step 60);
17. the multi-card PNN path (``repro_torch.launch.mesh_smoke``), one
   process a card under ``python -m torch.distributed.run`` over NCCL, on
   every card of the machine (one card: a (1, 1) mesh; four: (2, 2), and
   (4, 1) where ``MESH_MODEL_AXES`` asks): 8 PointNeXt requests through
   buckets 4096/16384 on the mesh against the same engine without one on
   each rank's card (the serving rule), the four serving kernels launched
   on every rank; 5 steps of pointnet2_seg at 8 x 16384, plain and int8,
   losses within 1e-4 of the one-card run, the parameters bit for bit the
   same on every rank; a 289,000-point scene, each point owned once, the
   same logits on every rank.  Any rank's failure fails the phase.

It then prints a ``{"kernels": [...]}`` line and, last, the device line.
Without a CUDA card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BUCKETS = (4096, 16384, 65536)
TH = 256
MICROBATCH = 4
REQUESTS = 8
SEED = 0
N_289K = 289_000
XL_ROOMS = 4             # a microbatch of the pointnext-xl.rooms-289k cell
PT_ROOMS = 2             # Point Transformer's microbatch here
TRAIN_N = 16384          # points a cloud: the middle serving bucket
TRAIN_BATCH = 8
TRAIN_STEPS = 20
PARITY_N = 4096
GLOBAL_BUCKETS = (4096, 16384)
SCENE = dict(tile_points=4096, halo=0.15, th=TH, microbatch=MICROBATCH,
             variant="pointnet2")        # examples/segment_scene.py
SCENE_SMALL_N = 16_384
SCENE_N = 1_000_000
# The PNN cells of launch/pnn_cell.py: (variant, shape, kind, batch); no
# batch takes the largest that fits on the card.
CELLS = (("pointnext", "pnn_289k", "serve", None),
         ("pointnext", "pnn_33k", "train", None),
         ("pointvector", "pnn_289k", "serve", 1),
         ("pointnext", "pnn_1m", "serve", 1))
CELL_PARITY_N = 4096
SLEEP_CYCLES_PER_S = 2.0e9   # at or above the H100's SM clock (1.98 GHz)
# The thin clients (phase_examples): serving PointNeXt at its published
# widths on the buckets of phases 4-6; the scene client at the 289k points
# of the PNN cells; train_pointnet at pointnet2_cls's own n and th, the
# full size of benchmarks/accuracy.py, with the reference's 8 x 16 final
# eval clouds; the LM smoke as the reference runs it, with int8.
EX_REQUESTS = 24
EX_SERVE = ["--buckets", ",".join(map(str, BUCKETS)), "--requests",
            str(EX_REQUESTS), "--microbatch", str(MICROBATCH), "--variant",
            "pointnext", "--th", str(TH)]
EX_SCENE = ["--n", str(N_289K), "--tile-points", "16384", "--microbatch",
            str(MICROBATCH)]
EX_TRAIN_STEPS = 300
EX_TRAIN = ["--steps", str(EX_TRAIN_STEPS), "--batch", "16", "--n-points",
            "1024", "--th", "64"]
EX_EVAL_CLOUDS = 8 * 16
EX_LM_STEPS = 60
EX_LM = ["--arch", "smollm-135m", "--steps", str(EX_LM_STEPS),
         "--compression", "int8"]
QUICKSTART_TOL = 1e-6   # mean count and recall, card vs CPU
# The LM smoke's per-step losses, card vs CPU (float32; int8 codec with the
# same hashed uniforms on both).  Its loss stays at ln(512) over 60 steps,
# in the reference's own run as in the port's, so a falling loss is not
# asked for.
LM_SMOKE_TOL = 1e-3
LOGIT_TOL = 1e-3      # card vs CPU: float32 matmuls sum in another order
LOGIT_SHARE = 0.999   # share of points within LOGIT_TOL

REPLACES = {
    "fps_blocks": "src/repro/kernels/fps.py:62",
    "ball_query_blocks": "src/repro/kernels/ball_query.py:43",
    "knn_blocks": "src/repro/kernels/knn.py:31",
    "gather_blocks": "src/repro/kernels/gather.py:30",
    "scatter_add_blocks": "src/repro/kernels/gather.py:65",
    "fractal_level_blocks": "src/repro/kernels/fractal_engine.py:47",
}
SERVING = ("fps_blocks", "ball_query_blocks", "knn_blocks", "gather_blocks")
TRAINING = SERVING + ("scatter_add_blocks",)
# What a served segmentation microbatch launches: the point ops and the FP
# blend (held call by call on the main path's own inputs) and the
# partition's level pass (held on the main path's clouds by
# ``phase_partition``).
SERVED = SERVING + ("interp_blend", "partition")
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name.rsplit('_', 1)[0]}.cu"
           for name in REPLACES}
LEVEL_DIMS_TIMED = (0, 1)   # the (da, db) pair whose leaf-block call is timed
# Phase 14: the LM architectures held card vs CPU in float32 (published
# widths, one repetition of the pattern): (arch, batch, prompt, decode
# steps).  gemma2-2b also at a prompt past the attention's flash threshold
# (4096 keys): the chunked attention in both layers, and a 4096-slot
# rolling cache that prefill fills past its size and decode wraps again;
# zamba2-7b at 4200 tokens: 33 SSD chunks of 128, the last padded, and the
# shared attention's 4096-slot rolling cache past its wrap; xlstm-1.3b at
# 200 tokens: 4 mLSTM chunks of 64, the last padded, and 200 sLSTM steps.
LM_ARCHS = ("smollm-135m", "minitron-4b", "gemma2-2b", "gemma3-12b",
            "chameleon-34b", "seamless-m4t-medium", "granite-moe-3b-a800m",
            "llama4-scout-17b-16e", "zamba2-7b", "xlstm-1.3b")
LM_HOLD = (tuple((arch, 2, 32, 4) for arch in LM_ARCHS)
           + (("gemma2-2b", 1, 4200, 4), ("zamba2-7b", 1, 4200, 4),
              ("xlstm-1.3b", 1, 200, 4)))
# At full config in bfloat16, card vs CPU: (arch, batch, prompt, steps).
# The card's bfloat16 logits may differ from the CPU's by at most
# LM_BF16_SLACK times the relative L2 gap between the CPU's bfloat16 and
# float32 logits (the dtype's own rounding on the same weights).
LM_HOLD_BF16 = (("smollm-135m", 2, 32, 4), ("granite-moe-3b-a800m", 2, 32, 4))
LM_BF16_SLACK = 2.0
# Served at full width through launch.serve.generate: (arch, batch, prompt,
# new tokens, layers or None for the config's own depth).  llama4's 48
# layers are ~436 GB of float32 weights (~218 GB in bfloat16) and do not
# fit one 80 GB card: it runs 4 (~43.5 GB, room left for the per-call
# bfloat16 casts of its expert weights).
# Phase 15: LM training.  First-step gradients card vs CPU, float32, one
# repetition of the pattern at published widths, on 1 x LM_GRAD_TOKENS
# tokens, for six archs that between them hold every block kind: attn;
# local, softcaps, post-norm; enc_attn, xattn, frames; moe; mamba,
# shared_attn; mlstm, slstm.
LM_GRAD_ARCHS = ("smollm-135m", "gemma2-2b", "seamless-m4t-medium",
                 "granite-moe-3b-a800m", "zamba2-7b", "xlstm-1.3b")
LM_GRAD_TOKENS = 64
# launch.train at full config: (batch, seq, microbatch); TRAIN_STEPS steps,
# then a checkpointed run to LM_CKPT_STEPS and a rerun to LM_RESUME_STEPS,
# then LM_INT8_STEPS with int8 compression.
LM_TRAIN_ARCH = "smollm-135m"
LM_TRAIN_SHAPE = (8, 4096, 8)
LM_CKPT_STEPS, LM_RESUME_STEPS, LM_INT8_STEPS = 10, 12, 5
# LM cells through launch.dryrun.run_cell: (arch, shape, batch or None to
# fit it); prefill_32k at batch 1 (its float32 chunked attention takes
# ~1 s a sequence).
LM_CELLS = (("smollm-135m", "train_4k", None),
            ("smollm-135m", "prefill_32k", 1),
            ("smollm-135m", "decode_32k", None),
            ("zamba2-7b", "long_500k", None))
LM_CELL_REPS = 2
MESH_MODEL_AXES = (2,)   # the reference's default; (1, 2) for (4, 1) too
MESH_TIMEOUT_S = 600
LM_SERVE = (("smollm-135m", 8, 512, 64, None),
            ("gemma2-2b", 1, 8192, 32, None),
            ("granite-moe-3b-a800m", 8, 512, 64, None),
            ("llama4-scout-17b-16e", 8, 512, 64, 4),
            ("zamba2-7b", 1, 8192, 32, None),
            ("xlstm-1.3b", 4, 1024, 64, None))


def log(msg=""):
    print(msg, flush=True)


def clustered_cloud(n: int, seed: int) -> np.ndarray:
    """Two objects and clutter, as in examples/quickstart.py, scaled to n."""
    rng = np.random.default_rng(seed)
    a, b = int(0.49 * n), int(0.37 * n)
    return np.concatenate([
        rng.normal([0, 0, 0], 0.3, (a, 3)),
        rng.normal([3, 1, 0], 0.5, (b, 3)),
        rng.uniform(-1, 4, (n - a - b, 3)),
    ]).astype(np.float32)


# ---------------------------------------------------------------------------
# Timing and bounds.
# ---------------------------------------------------------------------------

def median_ms(fn, reps: int, warmup: int = 2, batch: int = 10) -> float:
    """The card's time for one call of ``fn``: the median over ``reps``
    samples of ``batch`` calls between two CUDA events, divided by
    ``batch``.  Each sample is queued behind ``torch.cuda._sleep``, long
    enough to keep the card busy while the host enqueues the batch, so the
    card runs the calls back to back: a short kernel is timed by the card,
    not by the host's cost of one launch (a wrapper call takes tens of
    microseconds of host time).  With ``batch=1`` a call that enqueues many
    operations (a plain version) is timed with its host time."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / max(warmup, 1)
    sleep = (int(min(max(4 * host_s * batch, 2e-4), 0.5) * SLEEP_CYCLES_PER_S)
             if batch > 1 else 0)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if sleep:
            torch.cuda._sleep(sleep)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` and ``ops`` at the H100's published
    HBM and float32 rates (``repro_torch.launch.roofline``); comparisons
    and selects count as float32 operations."""
    from repro_torch.launch import roofline
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    t_ops = ops / roofline.PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel against plain.
# ---------------------------------------------------------------------------

def library_calls(name, args) -> dict:
    """PyTorch calls that compute the same function on these inputs, where
    there are: a gather whose indices all lie in the window is
    ``torch.gather`` (with the index widened to (NB, M, C)) or advanced
    indexing (with the (NB, M) index); a scatter-add is ``scatter_add_``
    along dim 1 into a zeroed (NB, W+1, C) buffer (index widened to
    (NB, M, C), out-of-range rows sent to the sink row W) or
    ``index_add_`` into its flattened (NB*(W+1), C) view.  Each is timed;
    the fastest is reported.  The indices are prepared outside the timed
    call; the zeroed buffer is part of it, as the kernel writes its zeros
    too."""
    import torch
    if name == "scatter_add_blocks":
        g, idx, w = args["g"], args["idx"], args["w"]
        nb, m, c = g.shape
        slot = torch.where((idx >= 0) & (idx < w), idx.long(), w)
        wide = slot[..., None].expand(nb, m, c).contiguous()
        flat = (slot + torch.arange(nb, device=g.device)[:, None] * (w + 1)
                ).reshape(-1)
        g2 = g.reshape(nb * m, c)
        return {
            "scatter_add_": lambda: g.new_zeros((nb, w + 1, c)).scatter_add_(
                1, wide, g),
            "index_add_": lambda: g.new_zeros((nb * (w + 1), c)).index_add_(
                0, flat, g2)}
    if name == "local_aggregate":
        return unfused_aggregate(args)
    if name == "interp_blend":
        return former_blend(args)
    if name == "vector_attention":
        return former_attention(args)
    if name != "gather_blocks":
        return {}
    f, idx = args["feats"], args["idx"]
    if bool(((idx < 0) | (idx >= f.shape[1])).any()):
        return {}
    wide = idx.long()[..., None].expand(*idx.shape, f.shape[2]).contiguous()
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {"torch.gather": lambda: torch.gather(f, 1, wide),
            "indexing": lambda: f[rows, idx]}


def unfused_aggregate(args) -> dict:
    """The InvResMLP blocks' local aggregation as the port ran it before
    ``local_aggregate``: the grouped (B, m, ns, C + 3) tensor by ``take``
    and ``cat``, the folded layer as one ``addmm``, ReLU and the masked
    max-pool, here over g with the identity as the layer's feature rows,
    which is the same function at the same cost.  Nothing where a slot's
    index lies outside the cloud (``take`` would read past it)."""
    import torch
    from repro_torch.core.fractal import take
    from repro_torch.models import pnn
    g, nidx, gmask, rel = (args[k] for k in ("g", "nidx", "gmask", "rel"))
    if bool(((nidx < 0) | (nidx >= g.shape[1])).any()):
        return {}
    c = g.shape[2]
    w = torch.cat([args["w_r"], torch.eye(c, device=g.device)])

    def unfused():
        grouped = torch.cat([rel, take(g, nidx)], -1)
        h = torch.relu(torch.addmm(args["bias"], grouped.view(-1, c + 3), w))
        return pnn._pool(h.view(*grouped.shape[:-1], c), gmask)
    return {"take+cat+addmm+relu+pool": unfused}


def former_blend(args) -> dict:
    """The FP blend as the port ran it before ``interp_blend``: the product
    of every lane's three rows with their weights, ``sum(-2)``, and a
    ``scatter_`` of every lane into a (B, R + 1, C) buffer whose last row
    takes the lanes that write no row.  The index is widened and the buffer
    zeroed outside the timed call."""
    import torch
    from repro_torch.kernels.interp_blend import occupied_rows
    out, vals, wgt = args["out"], args["vals"], args["wgt"]
    b, r, c = out.shape
    nb, bs = wgt.shape[:2]
    if nb == 0:
        return {}
    row, keep = occupied_rows(r, args["leaf_start"], args["count"], bs)
    wide = torch.where(keep, row, r).reshape(b, -1, 1).expand(b, -1, c)
    buf = out.new_zeros((b, r + 1, c))
    lanes = vals.view(b, nb // b, bs, 3, c)
    w = wgt.view(b, nb // b, bs, 3, 1)

    def former():
        blended = (lanes * w).sum(-2)
        return buf.scatter_(1, wide, blended.view(b, -1, c))
    return {"mul+sum+scatter_": former}


def former_attention(args) -> dict:
    """Point Transformer's attention layer as the port ran it before
    ``vector_attention``: its PyTorch sequence over (B, m, k, .) tensors,
    which ``vector_attention_plain`` keeps, on device time.  A masked
    slot's index is clamped into the cloud outside the timed call, as the
    former gather needed."""
    import torch
    from repro_torch.kernels.vector_attention import vector_attention_plain
    m = args["qkv"].shape[1]
    a = dict(args, nidx=torch.where(args["mask"], args["nidx"], 0).clamp(
        0, m - 1))
    return {"former sequence": lambda: vector_attention_plain(**a)}


def shape_of(name, args):
    if name == "vector_attention":
        b, m, c3 = args["qkv"].shape
        return (f"B={b} m={m} C={c3 // 3} k={args['nidx'].shape[2]} "
                f"N={args['w2w'].shape[0]}")
    if name == "interp_blend":
        b, _, c = args["out"].shape
        nb, bs = args["wgt"].shape[:2]
        return (f"B={b} leaves={nb // max(b, 1)} bs={bs} C={c} "
                f"lanes={int(args['count'].clamp(max=bs).sum())}")
    if name == "local_aggregate":
        b, m, c = args["g"].shape
        return f"B={b} m={m} C={c} ns={args['nidx'].shape[2]}"
    if name == "fps_blocks":
        nb, bs = args["mask"].shape
        return f"NB={nb} BS={bs} k={args['k']}"
    if name == "gather_blocks":
        nb, w, c = args["feats"].shape
        return f"NB={nb} W={w} C={c} M={args['idx'].shape[1]}"
    if name == "scatter_add_blocks":
        nb, m, c = args["g"].shape
        return f"NB={nb} W={args['w']} C={c} M={m}"
    if name == "fractal_level_blocks":
        nb, bs = args["mask"].shape
        return f"NB={nb} BS={bs} da={args['da']} db={args['db']}"
    nb, nq = args["q"].shape[:2]
    return f"NB={nb} Q={nq} W={args['window'].shape[1]} k={args['num']}"


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.library()
    log(f"built {Path(_build.build_log['path']).name} in "
        f"{time.monotonic() - t0:.1f} s (reused an earlier build: "
        f"{_build.build_log['reused']})")
    for src, text in sorted(_build.build_log.get("ptxas", {}).items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


def phase_analysis(smi: str):
    """The contract linter and the interface checks of
    ``repro_torch.analysis`` on the card; raises on any finding, or if a
    kernel variant of the library was reached by no checked launch."""
    from repro_torch.analysis import abstract, report, walker
    t0 = time.monotonic()
    findings = walker.lint_tree()
    findings += abstract.run_matrix_checks(device="cuda")
    launch_findings, rows = abstract.run_launch_checks()
    findings += launch_findings
    log(f"analysis ({smi}): lint + {len(abstract.MATRIX)}-row interface "
        f"matrix on cpu and cuda + {sum(r['launches'] for r in rows.values())}"
        f" launch geometries in {time.monotonic() - t0:.1f} s")
    for name in abstract.all_variants():
        if name not in rows:
            continue
        r = rows[name]
        log(f"  {name:26s} {r['source']:17s} {r['num_regs']:3d} registers, "
            f"{r['local_bytes']} local bytes, {r['static_smem']} static + "
            f"<= {r['max_smem']} dynamic shared bytes, threads "
            f"{sorted(r['threads'])}, >= {r['min_ctas_per_sm']} CTAs/SM, "
            f"{r['launches']} launches checked")
    missing = sorted(set(abstract.all_variants()) - set(rows))
    if missing:
        raise AssertionError(f"analysis: no checked launch reached {missing}")
    for f in report.sort_findings(findings):
        log(f"  {f.format()}")
    if findings:
        raise AssertionError(f"analysis: {report.summarize(findings)}")


def phase_ladder(device):
    from repro_torch.kernels import checks
    rows = 0
    calls = checks.ladder(device)
    for name, args in calls:
        rows += checks.hold(name, args)["count_rows"]
    stride1 = len(checks.stride1_ladder(device))
    knn1 = len(checks.knn_stride1_ladder(device))
    log(f"ladder: {len(calls)} kernel calls match their plain versions "
        f"(ball query and kNN exactly; {rows} ball-query count rows off by "
        f"their boundary lanes; {stride1} ball queries at the InvResMLP "
        f"blocks' stride-1 shape, 256 centres over 512 lanes, num 32; "
        f"{knn1} kNN calls at Point Transformer's, 256 queries over 512 "
        f"lanes, k 8 and 16)")


def make_engine(device, params=None):
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=BUCKETS, microbatch=MICROBATCH, variant="pointnet2",
                      task="seg", num_classes=6, th=TH)
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def hold_and_time(calls) -> dict:
    """Hold and time every recorded kernel call; returns {kernel name:
    sums over its calls of ms, plain_ms, bytes, ops, library_ms, and the
    largest error}.  ``calls`` is emptied as it goes, so a call's inputs
    leave the card once it is timed (the FP stages' gathered rows of a
    microbatch do not all fit beside the largest call's plain version)."""
    import torch
    from repro_torch.kernels import checks
    rows = {}
    while calls:
        name, args = calls.pop(0)
        res = checks.hold(name, args)
        run_kernel, run_plain = checks.runners(name, args)
        ms = median_ms(run_kernel, reps=20)
        plain_ms = median_ms(run_plain, reps=5, warmup=1, batch=1)
        libs = {label: median_ms(fn, reps=20)
                for label, fn in library_calls(name, args).items()}
        lib_ms = min(libs.values()) if libs else None
        nbytes, ops = checks.work(name, args)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {name:18s} {shape_of(name, args):38s} kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bms:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop)  library "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in libs.items()) or "-")
            + f"  max|err| {res['max_abs_err']:.3g}  count rows "
            f"{res['count_rows']}")
        row = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, bytes=0.0,
                                         ops=0.0, library_ms=0.0, err=0.0,
                                         calls=0))
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes"] += nbytes
        row["ops"] += ops
        row["library_ms"] = (None if lib_ms is None or row["library_ms"] is None
                             else row["library_ms"] + lib_ms)
        row["err"] = max(row["err"], res["max_abs_err"])
        row["calls"] += 1
    torch.cuda.synchronize()
    return rows


def phase_main_path_kernels(engine):
    """Record the kernel inputs of one full microbatch of the largest
    bucket, served through the engine, then hold and time every kernel
    call on them."""
    from repro_torch.kernels import checks
    b = BUCKETS[-1]
    with checks.Recorder() as rec:
        rids = [engine.submit(clustered_cloud(b, 100 + i))
                for i in range(MICROBATCH)]
        engine.flush()
    for rid in rids:
        engine.take(rid)
    rows = hold_and_time(rec.calls)
    missing = set(SERVING) - set(rows)
    if missing:
        raise AssertionError(f"main path made no call to {sorted(missing)}")
    return rows


def phase_serve(engine):
    """The main path: 8 mixed-size requests through the engine, with the
    kernel launch counts read around the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import mixed_request_sizes
    sizes = mixed_request_sizes(BUCKETS, REQUESTS, seed=SEED)
    clouds = [clustered_cloud(n, SEED + i) for i, n in enumerate(sizes)]
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rids = [engine.submit(c) for c in clouds]
    engine.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    log(f"served {len(rids)} requests of sizes {sizes} in {wall:.3f} s")
    log(f"launches during serving: {launches}")
    idle = [k for k in SERVED if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    results = {}
    for i, (rid, c) in enumerate(zip(rids, clouds)):
        out = engine.take(rid)
        if out is None or out.shape != (len(c), 6):
            raise AssertionError(f"request {rid}: bad result shape "
                                 f"{None if out is None else out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError(f"request {rid}: non-finite logits")
        results[i] = out
    buckets = sorted({engine.policy.select(len(c)) for c in clouds})
    if tuple(buckets) != BUCKETS:
        raise AssertionError(f"stream touched buckets {buckets} only")
    st = engine.stats()
    st["plan_cache"]["traces"] = {
        "/".join(map(str, k)): v for k, v in st["plan_cache"]["traces"].items()}
    log("stats: " + json.dumps(st))
    return clouds, results, launches


def hold_logits(pairs, title: str, units=("clouds", "points")) -> None:
    """Card logits against CPU logits, (got, want) per cloud: |difference|
    <= LOGIT_TOL on >= LOGIT_SHARE of the points (rows), or raise."""
    total = over = 0
    worst = 0.0
    for got, want in pairs:
        if got.shape != want.shape:
            raise AssertionError(f"{title}: shapes {got.shape} vs "
                                 f"{want.shape}")
        diff = np.abs(got - want).max(-1)
        total += len(diff)
        over += int((diff > LOGIT_TOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - over / total
    log(f"{title}, card vs CPU: {len(pairs)} {units[0]}, {total} "
        f"{units[1]}, "
        f"{over} over {LOGIT_TOL} (share within {share:.6f}), max |d| "
        f"{worst:.3g}")
    if share < LOGIT_SHARE:
        raise AssertionError(f"{title}: card and CPU logits disagree")


def serve_on_cpu(cpu, clouds) -> list:
    rids = [cpu.submit(c) for c in clouds]
    cpu.flush()
    return [cpu.take(rid) for rid in rids]


def phase_cpu_reference(engine, clouds, results):
    """The 4096-bucket requests again on the CPU (plain versions, same
    weights), held by ``hold_logits``."""
    import copy
    small = [i for i, c in enumerate(clouds) if len(c) <= BUCKETS[0]]
    cpu = make_engine("cpu", params=copy.deepcopy(engine.params).cpu())
    wants = serve_on_cpu(cpu, [clouds[i] for i in small])
    hold_logits([(results[i], w) for i, w in zip(small, wants)],
                "4096 bucket")


def phase_289k(engine):
    import torch
    from repro_torch.models import pnn
    cfg = pnn.pointnet2_seg(n=N_289K, point_ops="bppo", th=TH)
    pts = torch.from_numpy(clustered_cloud(N_289K, 289))[None].cuda()
    with torch.inference_mode():
        pnn.apply(engine.params, cfg, pts).cpu()           # first use
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = pnn.apply(engine.params, cfg, pts)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
    out = out.cpu().numpy()
    if out.shape != (1, N_289K, 6) or not np.isfinite(out).all():
        raise AssertionError(f"289k forward: bad output {out.shape}")
    log(f"289k cloud: pnn.apply {dt * 1e3:.1f} ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def level_calls() -> list:
    """[("fractal_level_blocks", arguments)] on the main path's own blocks,
    one call for every (da, db) pair: the stage-0 leaf blocks of one
    microbatch of the largest bucket (the clouds of
    ``phase_main_path_kernels``), each split at its valid midpoint on
    ``da``."""
    import torch
    from repro_torch.core import fractal
    from repro_torch.kernels import checks
    clouds = torch.from_numpy(np.stack(
        [clustered_cloud(BUCKETS[-1], 100 + i)
         for i in range(MICROBATCH)])).cuda()
    part = fractal.partition(clouds, th=TH, on_overflow="silent")
    view, mask, _ = fractal.leaf_view(part, part.coords, TH)
    return [("fractal_level_blocks", checks.level_at_midpoints(view, mask, da,
                                                              db))
            for da, db in checks.LEVEL_DIMS]


def phase_level_kernel() -> dict:
    """``fractal_level_blocks`` (on no path) on the main path's own blocks
    (``level_calls``): held for every (da, db) pair, timed for one."""
    from repro_torch.kernels import checks
    calls = level_calls()
    for name, args in calls:
        checks.hold(name, args)
    log(f"fractal_level_blocks on {MICROBATCH}x{BUCKETS[-1]} leaf blocks "
        f"({int(calls[0][1]['mask'].sum())} valid lanes): all three (da, db) "
        f"pairs equal their plain versions")
    return hold_and_time([(n, a) for n, a in calls
                          if (a["da"], a["db"]) == LEVEL_DIMS_TIMED])


def partition_calls() -> list:
    """[("partition", arguments)] on the main path's own clouds at th=TH:
    a blocks microbatch (4 x 4096 points, each cloud phased on its own
    dim0) and a rooms microbatch (8 x 289,000 points of the port's scene
    generator), each at the engine's depth."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import checks
    blocks = torch.from_numpy(np.stack([clustered_cloud(4096, 300 + i)
                                        for i in range(4)])).cuda()
    bvalid = torch.ones(blocks.shape[:2], dtype=torch.bool, device="cuda")
    rooms = torch.stack([synthetic.scene(s, N_289K, device="cuda")[0]
                         for s in range(8)])
    rvalid = torch.ones(rooms.shape[:2], dtype=torch.bool, device="cuda")
    return [("partition", checks.partition_args(
                blocks, bvalid, th=TH, dim0=torch.tensor([0, 1, 2, 0]))),
            ("partition", checks.partition_args(
                rooms, rvalid, th=TH, dim0=torch.zeros(8, dtype=torch.long)))]


def phase_partition() -> dict:
    """The partition's level pass against its tensor pass on the main
    path's clouds (``partition_calls``), every field exactly; the kernel's
    device time, its host time a call (enqueue only), its launches a call,
    the tensor pass's time (host included) and the bound in bytes."""
    import torch
    from repro_torch.kernels import checks, partition
    rows = {}
    for name, args in partition_calls():
        checks.hold(name, args)
        run_kernel, run_plain = checks.runners(name, args)
        before = partition.partition.launches
        run_kernel()
        launches = partition.partition.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            run_kernel()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.synchronize()
        ms = median_ms(run_kernel, reps=20)
        plain_ms = median_ms(run_plain, reps=5, warmup=1, batch=1)
        nbytes, ops = checks.work(name, args)
        bms, by = bound_ms(nbytes, ops)
        b, n = args["valid"].shape
        log(f"  partition B={b} n={n} depth={args['depth']} ML={args['ml']}: "
            f"kernel {ms:.4f} ms (host {host_ms:.4f} ms a call, {launches} "
            f"launches)  plain {plain_ms:.4f} ms  bound {bms:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB)  every field equal")
        rows[f"{b}x{n}"] = dict(ms=ms, host_ms=host_ms,
                                launches_a_call=launches, plain_ms=plain_ms,
                                bound_ms=bms)
    return rows


def xl_engine(device, params=None):
    """PointNeXt-XL (``pnn.pointnext_xl_seg``: variant pointnext_invres,
    published widths, all 15 InvResMLP blocks, BPPO at th=TH) behind a
    ``ServeEngine`` of one 289,000-point bucket, XL_ROOMS a microbatch,
    seeded random weights."""
    from repro_torch.models import pnn
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import MODEL_FIELDS
    m = pnn.pointnext_xl_seg(n=N_289K, point_ops="bppo", th=TH)
    cfg = ServeConfig(buckets=(N_289K,), microbatch=XL_ROOMS,
                      variant=m.variant, task=m.task,
                      num_classes=m.num_classes, th=TH, on_overflow="silent",
                      **{k: getattr(m, k) for k in MODEL_FIELDS})
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def phase_invres_xl() -> tuple[dict, dict]:
    """PointNeXt-XL's main path: one microbatch of XL_ROOMS rooms of
    289,000 points (the port's scene generator) served through
    ``xl_engine``, with every kernel's launch count read around that run
    (reset just before it) and its kernel calls recorded.  Fails if a
    kernel of SERVED is not launched, if an answer is not finite logits of
    its room's shape, if the blocks' searches are not one a stage, or if
    ``local_aggregate`` did not launch once a block.  Then every recorded
    call (the InvResMLP blocks' stride-1 ball queries among them, 256
    centres a leaf block over 512 lanes, and their local aggregations, the
    first three at stage 0's B=4 m=72,250 C=128 ns=32) is held against its
    plain version (max |err| 0) and timed by ``hold_and_time``, with the
    unfused sequence it replaced as its library call.  Returns (its rows,
    the run's launches)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import checks, ops
    from repro_torch.models import pnn
    rooms = [synthetic.scene(400 + i, N_289K, device="cuda")[0].cpu().numpy()
             for i in range(XL_ROOMS)]
    eng = xl_engine(None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    with checks.Recorder() as rec:
        rids = [eng.submit(r) for r in rooms]
        eng.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    outs = [eng.take(rid) for rid in rids]
    model = eng.stats()["model"]
    log(f"pointnext-xl: {XL_ROOMS} x {N_289K} points served in {wall:.3f} s "
        f"(first microbatch), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}; model counts {model}; {len(rec.calls)} kernel calls")
    for rid, out in zip(rids, outs):
        if out is None or out.shape != (N_289K, 13) or \
                not np.isfinite(out).all():
            raise AssertionError(f"pointnext-xl request {rid}: bad result "
                                 f"{None if out is None else out.shape}")
    idle = [k for k in SERVED if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on PointNeXt-XL's main "
                             f"path: {idle}")
    blocks = pnn.pointnext_xl_seg().blocks
    want = {"res_queries": sum(1 for b in blocks if b),
            "res_blocks": sum(blocks)}
    if model != want:
        raise AssertionError(f"pointnext-xl: model counts {model}, not "
                             f"{want}")
    if launches["local_aggregate"] != want["res_blocks"]:
        raise AssertionError(f"pointnext-xl: local_aggregate launched "
                             f"{launches['local_aggregate']} times, not once "
                             f"a block ({want['res_blocks']})")
    fp = len(pnn.pointnext_xl_seg().fp_widths)
    if launches["interp_blend"] != fp:
        raise AssertionError(f"pointnext-xl: interp_blend launched "
                             f"{launches['interp_blend']} times, not once "
                             f"an FP stage ({fp})")
    del eng, outs
    torch.cuda.empty_cache()
    rows = hold_and_time(rec.calls)
    missing = set(SERVING + ("local_aggregate", "interp_blend")) - set(rows)
    if missing:
        raise AssertionError(f"PointNeXt-XL's main path made no call to "
                             f"{sorted(missing)}")
    return rows, launches


def pt_engine(device, params=None):
    """Point Transformer (``pnn.point_transformer_seg``: published widths,
    18 blocks, BPPO at th=TH) behind a ``ServeEngine`` of one
    289,000-point bucket, PT_ROOMS a microbatch, seeded random weights."""
    from repro_torch.models import pnn
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import MODEL_FIELDS
    m = pnn.point_transformer_seg(n=N_289K, point_ops="bppo", th=TH)
    cfg = ServeConfig(buckets=(N_289K,), microbatch=PT_ROOMS,
                      variant=m.variant, task=m.task,
                      num_classes=m.num_classes, th=TH, on_overflow="silent",
                      **{k: getattr(m, k) for k in MODEL_FIELDS})
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def phase_point_transformer() -> tuple[dict, dict]:
    """Point Transformer's main path: one microbatch of PT_ROOMS rooms of
    289,000 points served through ``pt_engine``, with every kernel's launch
    count reset just before it and its kernel calls recorded.  Fails if an answer is not finite logits of
    its room's shape, if the model did not count one search a level and
    each block once, or if any kernel launched other than its structure
    asks: ``knn_blocks`` once a level's stride-1 search, once a
    TransitionDown and once a TransitionUp's 3-NN search; ``fps_blocks``
    once a TransitionDown; ``gather_blocks`` and ``interp_blend`` once a
    TransitionUp; ``vector_attention`` once a block; the partition at least
    once; no other (so no point op ran as a plain fallback).  Then every
    recorded call (the stride-1 searches at each level's leaf blocks, 256
    queries over 512 lanes at k 8 and 16, and the 18 attention layers,
    beside the PyTorch sequence they replace, among them) is held against
    its plain version and timed by ``hold_and_time`` beside its bound.
    Returns (its rows, the run's launches)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import checks, ops
    from repro_torch.models import pnn, point_transformer
    rooms = [synthetic.scene(500 + i, N_289K, device="cuda")[0].cpu().numpy()
             for i in range(PT_ROOMS)]
    m = pnn.point_transformer_seg(n=N_289K, point_ops="bppo", th=TH)
    levels, downs = 1 + len(m.stages), len(m.stages)
    eng = pt_engine(None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    with checks.Recorder() as rec:
        rids = [eng.submit(r) for r in rooms]
        eng.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    outs = [eng.take(rid) for rid in rids]
    model = eng.stats()["model"]
    log(f"point-transformer: {PT_ROOMS} x {N_289K} points served in "
        f"{wall:.3f} s (first microbatch), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}; model counts {model}; {len(rec.calls)} kernel calls")
    for rid, out in zip(rids, outs):
        if out is None or out.shape != (N_289K, 13) or \
                not np.isfinite(out).all():
            raise AssertionError(f"point-transformer request {rid}: bad "
                                 f"result {None if out is None else out.shape}")
    want = {"pt_searches": levels,
            "pt_blocks": sum(m.enc_blocks) + levels}
    if model != want:
        raise AssertionError(f"point-transformer: model counts {model}, not "
                             f"{want}")
    expect = dict.fromkeys(launches, 0)
    expect.update(knn_blocks=levels + 2 * downs, fps_blocks=downs,
                  gather_blocks=downs, interp_blend=downs,
                  vector_attention=want["pt_blocks"])
    wrong = {k: (v, expect[k]) for k, v in launches.items()
             if k != "partition" and v != expect[k]}
    if wrong or not launches["partition"]:
        raise AssertionError(f"point-transformer: launches (got, wanted) "
                             f"{wrong}, partition {launches['partition']}")
    ks = point_transformer.level_k(m)
    stride1 = [(a["q"].shape[0], a["num"]) for n, a in rec.calls
               if n == "knn_blocks" and a["q"].shape[1] == TH
               and a["window"].shape[1] == 2 * TH]
    if [k for _, k in stride1] != list(ks):
        raise AssertionError(f"point-transformer: stride-1 kNN calls "
                             f"{stride1}, not one a level at k {ks}")
    del eng, outs
    torch.cuda.empty_cache()
    rows = hold_and_time(rec.calls)
    return rows, launches


def phase_interp_blend() -> dict:
    """The FP blend alone at level 0 of the XL cell's microbatch (XL_ROOMS
    rooms, 128 channels) and of the rooms cell's (8 rooms, 64 channels):
    each room of N_289K points from the port's scene generator, partitioned
    at th=TH as the path partitions it, its leaf blocks' starts and
    occupied counts, and the seed's rows and weights.  Each call is held
    against its plain version, timed by ``hold_and_time`` beside the
    multiply, ``sum`` and ``scatter_`` it replaced, and its rows compared
    with that sequence's, bit for bit.  Returns {label: its row}."""
    import torch
    from repro_torch.core import fractal
    from repro_torch.data import synthetic
    from repro_torch.kernels import checks
    rows = {}
    for label, b, c in (("pointnext-xl", XL_ROOMS, 128),
                        ("pointnext-s", 8, 64)):
        rooms = torch.stack([synthetic.scene(400 + i, N_289K,
                                             device="cuda")[0]
                             for i in range(b)])
        part = fractal.partition(rooms, th=TH, on_overflow="silent")
        count = torch.where(part.is_leaf, part.leaf_vsize.clamp(max=TH), 0)
        args = checks.blend_args(30 + b, part.leaf_start.cpu(), count.cpu(),
                                 N_289K, TH, c, "cuda")
        args["out"].zero_()
        fill = float(count.sum()) / count.numel() / TH
        del rooms, part
        kernel = checks.runners("interp_blend", args)[0]()
        former = former_blend(args)["mul+sum+scatter_"]()[:, :N_289K]
        same = bool(torch.equal(kernel.view(torch.int32),
                                former.view(torch.int32)))
        diff = float((kernel - former).abs().max())
        del kernel, former
        torch.cuda.empty_cache()
        log(f"interp_blend, {label} level 0 ({b} rooms, "
            f"{args['wgt'].shape[0] // b} leaf blocks a room, fill "
            f"{100 * fill:.3f} %): the kernel's "
            f"rows equal the former multiply, sum and scatter_'s bit for "
            f"bit: {same} (max |diff| {diff:.3g})")
        row = hold_and_time([("interp_blend", args)])["interp_blend"]
        rows[label] = dict(row, fill=fill, bits_equal_former=same)
        del args
        torch.cuda.empty_cache()
    return rows


def phase_profile(engine):
    """Where the time goes: one full microbatch per bucket under
    torch.profiler; device time by kernel, kernel launches, and the card's
    busy share of the wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for b in BUCKETS:
        clouds = [clustered_cloud(b, 500 + i) for i in range(MICROBATCH)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            rids = [engine.submit(c) for c in clouds]
            engine.flush()
            wall_us = (time.monotonic() - t0) * 1e6
        for rid in rids:
            engine.take(rid)
        report_profile(prof, wall_us,
                       f"profile bucket {b} (microbatch {MICROBATCH})")


def report_profile(prof, wall_us: float, title: str, top: int = 8):
    """Device time by kernel, device ops, the ported kernels' share and the
    card's idle share of ``wall_us``, from one ``torch.profiler`` run."""
    # The kernels of csrc/ live in an anonymous namespace.
    ported = tuple(f"(anonymous namespace)::{k}_kernel"
                   for k in ("fps_warp", "fps", "fps_wide", "ball_query",
                             "knn", "gather", "scatter_add", "fractal_level",
                             "local_aggregate", "interp_blend",
                             "vector_attention"))
    dev = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type.name == "CUDA":
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    busy = sum(us for us, _, _ in dev)
    launches = sum(c for _, c, _ in dev)
    mine = sum(us for us, _, k in dev if any(p in k for p in ported))
    if busy <= 0:
        raise AssertionError(f"{title}: the profiler saw no device time")
    log(f"{title}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms (idle share {1 - busy / wall_us:.3f}), "
        f"{launches} device ops, ported kernels {mine / 1e3:.2f} ms")
    for us, count, key in dev[:top]:
        log(f"    {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"busy_us": busy, "ops": launches, "idle": 1 - busy / wall_us}


# ---------------------------------------------------------------------------
# The global point ops and scene segmentation.
# ---------------------------------------------------------------------------

def global_engine(device, params):
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = ServeConfig(buckets=GLOBAL_BUCKETS, microbatch=MICROBATCH,
                      variant="pointnet2", task="seg", num_classes=6, th=TH,
                      point_ops="global")
    return ServeEngine(cfg, params=params, seed=SEED, device=device)


def serve_timed(engine, clouds) -> tuple[list, float]:
    """One microbatch through ``engine``: (logits per cloud, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rids = [engine.submit(c) for c in clouds]
    engine.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return [engine.take(rid) for rid in rids], wall


def phase_global(engine):
    """The global (O(n^2)) point ops through a plan-less ``ServeEngine``:
    one microbatch of 4 x 16384 clouds beside the BPPO engine on the same
    clouds (turns: bppo, global, global, bppo), with every kernel's launch
    count read around a global run; then the 4096-bucket logits held
    against the same engine on the CPU."""
    import copy
    from repro_torch.kernels import ops
    geng = global_engine(None, engine.params)
    log(f"global warm: {geng.warm()}")
    b = GLOBAL_BUCKETS[-1]
    clouds = [clustered_cloud(b, 700 + i) for i in range(MICROBATCH)]
    walls = {"bppo": [], "global": []}
    for kind in ("bppo", "global", "global", "bppo"):
        ops.reset_launch_counts()
        outs, wall = serve_timed(engine if kind == "bppo" else geng, clouds)
        walls[kind].append(wall)
        if kind == "global":
            launches, gouts = ops.launch_counts(), outs
        else:
            bouts = outs
    for o in gouts:
        if o.shape != (b, 6) or not np.isfinite(o).all():
            raise AssertionError(f"global serving: bad logits {o.shape}")
    agree = np.mean([(g.argmax(-1) == p.argmax(-1)).mean()
                     for g, p in zip(gouts, bouts)])
    log(f"{MICROBATCH}x{b} microbatch: global "
        + " / ".join(f"{w * 1e3:.1f}" for w in walls["global"])
        + " ms, bppo " + " / ".join(f"{w * 1e3:.1f}" for w in walls["bppo"])
        + f" ms; argmax agreement global vs bppo {agree:.4f} (random "
        f"weights); launches during a global microbatch: {launches}")
    b0 = GLOBAL_BUCKETS[0]
    small = [clustered_cloud(n, 800 + i)
             for i, n in enumerate((b0, 3 * b0 // 4, b0, b0 // 2))]
    got, _ = serve_timed(geng, small)
    t0 = time.monotonic()
    want = serve_on_cpu(global_engine(
        "cpu", copy.deepcopy(engine.params).cpu()), small)
    log(f"global {b0} bucket on the CPU: {time.monotonic() - t0:.1f} s")
    hold_logits(list(zip(got, want)), f"global {b0} bucket")


def scene_engine(device, params):
    from repro_torch.scene import SceneConfig, SceneEngine
    return SceneEngine(SceneConfig(**SCENE), params=params, seed=SEED,
                       device=device)


def phase_scene_small(eng):
    """A 16,384-point scene on the card and on the CPU (plain versions,
    same weights): the same tiling, logits by ``hold_logits``."""
    import copy
    from repro_torch.data import synthetic
    pts, _ = synthetic.scene(SEED, SCENE_SMALL_N, device="cuda")
    got, plan = eng.infer(pts)
    t0 = time.monotonic()
    want, cplan = scene_engine("cpu", copy.deepcopy(eng.params).cpu()).infer(
        pts.cpu())
    cpu_s = time.monotonic() - t0
    same = plan.num_tiles == cplan.num_tiles and all(
        np.array_equal(a.owned, b.owned) and np.array_equal(a.halo, b.halo)
        for a, b in zip(plan.tiles, cplan.tiles))
    log(f"scene {SCENE_SMALL_N}: {plan.num_tiles} tiles, "
        f"{plan.halo_points} halo points, tiling card == CPU: {same}; CPU "
        f"took {cpu_s:.1f} s")
    if not same:
        raise AssertionError("the card and the CPU tile the scene apart")
    hold_logits([(got, want)], f"scene {SCENE_SMALL_N}")


def phase_scene_1m(eng) -> dict:
    """The slice's main path: a 1,000,000-point scene generated on the
    card, tiled, and segmented through ``SceneEngine.infer``, with every
    kernel's launch count read around the inference."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pts, labels = synthetic.scene(SEED, SCENE_N, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    t0 = time.monotonic()
    plan = eng.plan(pts)
    tile_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    logits, _ = eng.infer(pts, plan=plan)
    torch.cuda.synchronize()
    infer_s = time.monotonic() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    owned = np.bincount(np.concatenate([t.owned for t in plan.tiles]),
                        minlength=SCENE_N)
    if owned.shape != (SCENE_N,) or not (owned == 1).all():
        raise AssertionError(f"1M scene: {int((owned != 1).sum())} points "
                             f"not owned exactly once")
    if logits.shape != (SCENE_N, 6) or not np.isfinite(logits).all():
        raise AssertionError(f"1M scene: bad logits {logits.shape}")
    sizes = [t.n for t in plan.tiles]
    st = eng.stats()
    log(f"scene {SCENE_N}: {plan.num_tiles} tiles (owned points per tile "
        f"{min(t.n_owned for t in plan.tiles)}-"
        f"{max(t.n_owned for t in plan.tiles)}), {plan.halo_points} halo "
        f"points, largest tile cloud {plan.max_tile_n}, mean "
        f"{np.mean(sizes):.0f}; {len(np.unique(labels.cpu().numpy()))} "
        f"shape classes")
    log(f"scene {SCENE_N}: generate {gen_s:.3f} s, tile {tile_s:.3f} s, "
        f"infer {infer_s:.3f} s ({SCENE_N / infer_s:,.0f} points/s; "
        f"{SCENE_N / (tile_s + infer_s):,.0f} points/s with tiling), peak "
        f"device memory during inference {peak:.2f} GiB; tile latency p50 "
        + " / ".join(f"{b}: {v['p50_ms']:.1f} ms x{v['count']}"
                     for b, v in st["buckets"].items()))
    log(f"launches during the 1M scene: {launches}")
    idle = [k for k in SERVED if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the scene path: "
                             f"{idle}")
    return launches


def phase_scene(params) -> dict:
    eng = scene_engine(None, params)
    log(f"scene warm: {eng.warm()}")
    phase_scene_small(eng)
    return phase_scene_1m(eng)


# ---------------------------------------------------------------------------
# The thin clients (repro_torch.examples).
# ---------------------------------------------------------------------------

def run_client(name: str, argv: list) -> tuple[dict, dict]:
    """``repro_torch.examples.<name>.main(argv)`` with every kernel's launch
    count read around it; logs the returned dict as one JSON line."""
    import importlib
    from repro_torch.kernels import ops
    main = importlib.import_module(f"repro_torch.examples.{name}").main
    ops.reset_launch_counts()
    t0 = time.monotonic()
    out = main(argv)
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    log(f"example {name} {' '.join(argv)}: {wall:.1f} s, launches "
        f"{launches}")
    log(json.dumps({"example": name, "argv": argv, "client_s": wall, **out},
                   default=str))
    return out, launches


def phase_examples() -> dict:
    """Each client of ``repro_torch.examples`` through its ``main`` on the
    card: quickstart against its own run on the CPU; serve_pnn and
    segment_scene at the sizes of EX_SERVE / EX_SCENE; train_pointnet with
    BPPO and with the global ops (and a resume of the BPPO run); the LM
    smoke and its rerun.  Returns {client: its launches}."""
    import tempfile
    launches = {}
    card, launches["quickstart"] = run_client("quickstart", [])
    cpu, _ = run_client("quickstart", ["--device", "cpu"])
    ints = [k for k, v in card.items() if isinstance(v, int)]
    if any(card[k] != cpu[k] for k in ints) or any(
            abs(card[k] - cpu[k]) > QUICKSTART_TOL
            for k in ("mean_cnt", "recall")):
        raise AssertionError(f"quickstart: card {card} vs CPU {cpu}")
    log(f"quickstart: card == CPU on {ints}; mean count and recall within "
        f"{QUICKSTART_TOL}")

    rep, launches["serve_pnn"] = run_client("serve_pnn", EX_SERVE)
    idle = [k for k in SERVING if rep["launches"][k] == 0]
    if rep["served"] != EX_REQUESTS or not rep["one_trace_per_key"] or idle:
        raise AssertionError(f"serve_pnn: served {rep['served']}, one trace "
                             f"per key {rep['one_trace_per_key']}, kernels "
                             f"not launched {idle}")

    sc, launches["segment_scene"] = run_client("segment_scene", EX_SCENE)
    if not (sc["owned_once"] and sc["finite"]):
        raise AssertionError(f"segment_scene: owned once {sc['owned_once']},"
                             f" finite logits {sc['finite']}")

    acc = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for ops_ in ("bppo", "global"):
            extra = ["--ckpt", ckpt] if ops_ == "bppo" else []
            tr, launches[f"train_pointnet {ops_}"] = run_client(
                "train_pointnet", EX_TRAIN + ["--point-ops", ops_, *extra])
            logged = [r["loss"] for r in tr["logged"]]
            hold_losses(logged, f"train_pointnet {ops_} (logged losses)",
                        steps=len(range(0, EX_TRAIN_STEPS, 25)))
            if not np.isfinite(tr["losses"]).all():
                raise AssertionError(f"train_pointnet {ops_}: a loss is not "
                                     f"finite")
            acc[ops_] = tr["final_accuracy"]
        again, _ = run_client("train_pointnet",
                              EX_TRAIN + ["--point-ops", "bppo", "--ckpt",
                                          ckpt])
    if (again["resumed_from"], again["losses"]) != (EX_TRAIN_STEPS, []) or \
            again["final_accuracy"] != acc["bppo"]:
        raise AssertionError(f"train_pointnet resume: from "
                             f"{again['resumed_from']}, accuracy "
                             f"{again['final_accuracy']} vs {acc['bppo']}")
    gap = acc["global"] - acc["bppo"]
    log(f"accuracy (Fig. 14): BPPO {acc['bppo']:.4f}, global "
        f"{acc['global']:.4f}, gap (global - BPPO) {gap * 100:+.2f} points "
        f"beside the paper's < 0.7 %; not gated: "
        f"{EX_EVAL_CLOUDS} eval clouds, a step of "
        f"{100 / EX_EVAL_CLOUDS:.2f} points")

    with tempfile.TemporaryDirectory() as ckpt, \
            tempfile.TemporaryDirectory() as cpu_ckpt:
        lm, launches["lm_pretrain_smoke"] = run_client(
            "lm_pretrain_smoke", EX_LM + ["--ckpt", ckpt])
        cpu_lm, _ = run_client("lm_pretrain_smoke",
                               EX_LM + ["--ckpt", cpu_ckpt, "--device", "cpu"])
        rerun, _ = run_client("lm_pretrain_smoke", EX_LM + ["--ckpt", ckpt])
    card_l, cpu_l = np.asarray(lm["losses"]), np.asarray(cpu_lm["losses"])
    if card_l.shape != (EX_LM_STEPS,) or cpu_l.shape != card_l.shape or \
            not np.isfinite(card_l).all():
        raise AssertionError(f"lm_pretrain_smoke: losses {card_l}")
    worst = float(np.abs(card_l - cpu_l).max())
    log(f"lm_pretrain_smoke: {EX_LM_STEPS} losses, card vs CPU max |d| "
        f"{worst:.3g} (limit {LM_SMOKE_TOL}); mean loss, first 5 steps "
        f"{card_l[:5].mean():.4f}, last 5 {card_l[-5:].mean():.4f} "
        f"(not gated: the reference's own run stays at ln(vocab))")
    if worst > LM_SMOKE_TOL:
        raise AssertionError("lm_pretrain_smoke: card and CPU losses differ")
    if (rerun["resumed_from"], rerun["steps_run"]) != (EX_LM_STEPS, 0):
        raise AssertionError(f"lm_pretrain_smoke rerun: resumed from "
                             f"{rerun['resumed_from']}, ran "
                             f"{rerun['steps_run']} steps")
    return launches


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def train_cfg(n: int, batch: int):
    from repro_torch.train import pnn as train
    return train.TrainConfig(preset="pointnet2_seg", n_points=n, th=TH,
                             batch=batch, steps=TRAIN_STEPS, seed=SEED)


def first_batch(cfg, device):
    """The batch ``fit`` trains on at step 0."""
    from repro_torch.data import synthetic
    pts, labels = synthetic.segmentation_batch(cfg.seed + 11, 0, cfg.batch,
                                               cfg.n_points, device=device)
    return {"points": pts, "labels": labels}


def phase_grad_parity(n: int, batch: int):
    """The first training step's loss and every parameter's gradient on
    the card against the CPU (plain versions), from the weights and the
    batch ``fit`` starts from, by ``checks.hold_grads``."""
    import copy
    import torch
    from repro_torch.kernels import checks, ops
    from repro_torch.models import pnn
    from repro_torch.train import pnn as train
    cfg = train_cfg(n, batch)
    mcfg = train.model_config(cfg)
    model = pnn.init(mcfg, torch.Generator().manual_seed(cfg.seed))
    t0 = time.monotonic()
    want, wm = train.grads_fn(model, mcfg)(train.param_dict(model),
                                           first_batch(cfg, "cpu"))
    cpu_s = time.monotonic() - t0
    card = copy.deepcopy(model).cuda()
    before = ops.launch_counts()["scatter_add_blocks"]
    got, gm = train.grads_fn(card, mcfg)(train.param_dict(card),
                                         first_batch(cfg, "cuda"))
    torch.cuda.synchronize()
    backward = ops.launch_counts()["scatter_add_blocks"] - before
    rel = checks.hold_grads(got, want)
    worst = max(rel, key=rel.get)
    log(f"gradients {batch}x{n}, card vs CPU: loss {float(gm['loss']):.7f} "
        f"vs {float(wm['loss']):.7f}; all {len(got)} parameters non-zero "
        f"on the card; largest relative L2 difference {rel[worst]:.3g} "
        f"({worst}; rule <= {checks.GRAD_REL_TOL}); scatter_add_blocks "
        f"launched {backward} times by the backward; CPU took {cpu_s:.1f} s")
    if backward == 0:
        raise AssertionError("the card's backward did not launch "
                             "scatter_add_blocks")


def phase_train():
    """The training path: ``fit`` for TRAIN_STEPS AdamW steps at
    TRAIN_BATCH x TRAIN_N points on the card, with every kernel's launch
    count read around the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import pnn as train
    cfg = train_cfg(TRAIN_N, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    model, state, info = train.fit(cfg, log=log)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    losses = [h["loss"] for h in info["history"]]
    dts = [h["dt"] * 1e3 for h in info["history"]]
    log(f"trained {len(losses)} steps of {cfg.batch}x{cfg.n_points} points "
        f"in {wall:.2f} s: median step {statistics.median(dts):.1f} ms "
        f"(first {dts[0]:.1f} ms), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("step ms: " + " ".join(f"{x:.1f}" for x in dts))
    log(f"launches during training: {launches}")
    hold_losses(losses, "training")
    idle = [k for k in TRAINING if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched in training: {idle}")
    return cfg, model, state, launches, statistics.median(dts)


def hold_losses(losses, title: str, steps: int = TRAIN_STEPS) -> None:
    """``steps`` finite losses whose last 5 average below their first 5,
    or raise."""
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{title}: bad losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"{title}: mean loss, first 5 steps {first:.4f}, last 5 steps "
        f"{last:.4f}")
    if not last < first:
        raise AssertionError(f"{title}: the loss did not fall")


def phase_train_kernels(cfg, model):
    """Record the kernel calls of one training step's forward and backward
    at full size, check that every parameter gets a gradient, and hold and
    time the gather's backward on that step's own cotangents."""
    from repro_torch.kernels import checks
    from repro_torch.train import pnn as train
    mcfg = train.model_config(cfg)
    with checks.Recorder() as rec:
        grads, _ = train.grads_fn(model, mcfg)(train.param_dict(model),
                                               first_batch(cfg, "cuda"))
    silent = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    if silent:
        raise AssertionError(f"parameters without gradient: {silent}")
    calls = [(n, a) for n, a in rec.calls if n == "scatter_add_blocks"]
    rec.calls.clear()
    if not calls:
        raise AssertionError("the training step made no scatter-add call")
    return hold_and_time(calls)


def phase_profile_train(cfg, model, state):
    """One more training step (forward, backward, AdamW) under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import pnn as train
    mcfg = train.model_config(cfg)
    step = train.make_train_step(model, mcfg, opt_lib.OptConfig(
        lr=cfg.lr, warmup=0, total_steps=cfg.steps,
        weight_decay=cfg.weight_decay))
    batch = first_batch(cfg, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, _, metrics = step(train.param_dict(model), state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    report_profile(prof, wall_us, f"profile training step "
                   f"({cfg.batch}x{cfg.n_points})", top=12)


def phase_train_compressed(plain_ms: float) -> dict:
    """``fit`` with each gradient codec (error feedback, keyed by (seed,
    step)) for TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_N points, with
    every kernel's launch count read around each run; the median step
    beside the uncompressed run's.  Returns {codec: its run's launches}."""
    import dataclasses
    import torch
    from repro_torch.dist import compression
    from repro_torch.kernels import ops
    from repro_torch.train import pnn as train
    total = {}
    for method in compression.METHODS[::-1]:          # int8, then bf16
        cfg = dataclasses.replace(train_cfg(TRAIN_N, TRAIN_BATCH),
                                  grad_compression=method)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        _, _, info = train.fit(cfg, log=log)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        losses = [h["loss"] for h in info["history"]]
        dts = [h["dt"] * 1e3 for h in info["history"]]
        log(f"trained {len(losses)} steps of {cfg.batch}x{cfg.n_points} "
            f"points with {method} compression: median step "
            f"{statistics.median(dts):.1f} ms against {plain_ms:.1f} ms "
            f"uncompressed (first {dts[0]:.1f} ms), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"{method} losses: " + " ".join(f"{x:.4f}" for x in losses))
        log(f"{method} step ms: " + " ".join(f"{x:.1f}" for x in dts))
        log(f"launches during {method} training: {launches}")
        hold_losses(losses, f"{method} training")
        idle = [k for k in TRAINING if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels not launched in {method} "
                                 f"training: {idle}")
        total[method] = launches
    return total


def phase_compressed_grads(n: int, batch: int):
    """The first training step's decompressed gradients (error feedback
    from a zero residual, key (seed, 0), as ``fit`` runs it) on the card
    against the CPU, from the same weights and batch, by
    ``checks.hold_grads``, for each codec; and the codec itself on the
    card against the CPU on the card's raw gradients, bit for bit."""
    import copy
    import torch
    from repro_torch.dist import compression
    from repro_torch.kernels import checks
    from repro_torch.models import pnn
    from repro_torch.train import pnn as train
    cfg = train_cfg(n, batch)
    mcfg = train.model_config(cfg)
    model = pnn.init(mcfg, torch.Generator().manual_seed(cfg.seed))
    want, _ = train.grads_fn(model, mcfg)(train.param_dict(model),
                                          first_batch(cfg, "cpu"))
    card = copy.deepcopy(model).cuda()
    got, _ = train.grads_fn(card, mcfg)(train.param_dict(card),
                                        first_batch(cfg, "cuda"))
    got_cpu = {k: g.cpu() for k, g in got.items()}
    key = (cfg.seed, 0)
    for method in compression.METHODS:
        def ef(grads):
            return compression.apply_error_feedback(
                grads, compression.init_residual(grads), method, key)
        (dg, rg), (dw, _), (dx, rx) = ef(got), ef(want), ef(got_cpu)
        same = all(torch.equal(dg[k].cpu(), dx[k])
                   and torch.equal(rg[k].cpu(), rx[k]) for k in dg)
        log(f"{method} codec on the card's gradients, card vs CPU: "
            f"{'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{method}: the codec on the card differs "
                                 f"from the CPU's on the same gradients")
        rel = checks.hold_grads(dg, dw)
        worst = max(rel, key=rel.get)
        log(f"{method} decompressed gradients {batch}x{n}, card vs CPU: all "
            f"{len(dg)} parameters non-zero on the card; largest relative "
            f"L2 difference {rel[worst]:.3g} ({worst}; rule <= "
            f"{checks.GRAD_REL_TOL})")


def phase_cells() -> tuple[dict, int]:
    """The paper's PNN cells through ``launch.pnn_cell.run_pnn_cell`` (a
    batch cut to what fits where none is given): each cell's row, every
    kernel call of one step held against its plain version (the cell
    raises on a difference), the launches of its timed steps, and the
    roofline table.  Returns ({cell: its timed steps' launches}, the
    first cell's batch)."""
    import torch
    from repro_torch.launch import pnn_cell, roofline
    rows, total = [], {}
    for variant, shape, kind, batch in CELLS:
        torch.cuda.empty_cache()
        d = pnn_cell.run_pnn_cell(variant, shape, batch=batch, kind=kind)
        launches = d["launches"]
        cut = (f"batch {d['batch']} of the reference's {d['ref_batch']}"
               + (f" (probe at batch 1: {d['probe']['probe_base_gib']:.2f} "
                  f"GiB before the step, {d['probe']['probe_step_gib']:.2f} "
                  f"GiB a cloud; estimate {d['probe']['estimate_gib']:.2f} "
                  f"GiB)" if d["probe"] else " (given)"))
        log(f"cell {variant} x {d['shape']}: {cut}; step "
            f"{d['step_s'] * 1e3:.2f} ms (median of {len(d['steps_s'])}: "
            + " / ".join(f"{t * 1e3:.2f}" for t in d["steps_s"])
            + f"), warm {d['warm_s']:.2f} s, peak "
            f"{d['mem_per_device']['peak_mb'] / 1024:.2f} GiB; counted "
            f"{d['hlo_flops_per_chip']:.4g} flop, {d['hlo_bytes_per_chip']:.4g}"
            f" B: t_compute {d['t_compute_s'] * 1e3:.3f} ms, t_memory "
            f"{d['t_memory_s'] * 1e3:.3f} ms ({d['bottleneck']}, "
            f"{d['bound_fraction'] * 100:.2f}% of the step), useful flops "
            f"{d['model_flops']:.4g} ({d['usefulness'] * 100:.1f}%); kernel "
            f"calls a step {d['kernel_calls']}; launches over the timed steps "
            f"{launches}; cell {d['total_s']:.1f} s")
        for name, h in d["held"].items():
            b = h["blocks"]
            log(f"  held {name}: {len(b)} calls of one step match their "
                f"plain versions (max|err| {h['max_abs_err']:.3g}, count "
                f"rows {h['count_rows']}); blocks a call: first {b[0]}, "
                f"last {b[-1]}, sizes {sorted(set(b))}")
        need = TRAINING if kind == "train" else SERVING
        idle = [k for k in need if launches[k] == 0 or k not in d["held"]]
        if idle:
            raise AssertionError(f"cell {variant} x {shape}: kernels not "
                                 f"launched or not held: {idle}")
        total[f"{variant} x {d['shape']}"] = launches
        rows.append(d)
    log(roofline.format_table(rows))
    return total, rows[0]["batch"]


def phase_profile_cell(batch: int):
    """One step of the first cell (PointNeXt serving at 289k points, at
    the batch ``phase_cells`` ran) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import pnn_cell
    variant, shape, kind, _ = CELLS[0]
    cell = pnn_cell.make_cell(variant, shape, batch=batch, kind=kind)
    cell.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        cell.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    report_profile(prof, wall_us, f"profile cell {variant} x {shape} "
                   f"({kind}, batch {batch})", top=12)


def phase_cell_parity():
    """PointNeXt and PointVector logits on the card against the CPU (plain
    versions, same weights and clouds) at CELL_PARITY_N points, by
    ``hold_logits``."""
    import copy
    from repro_torch.launch import pnn_cell
    shape = pnn_cell.PNNShape("parity", CELL_PARITY_N, 2, TH)
    for variant in ("pointnext", "pointvector"):
        cell = pnn_cell.make_cell(variant, shape, device="cuda")
        got = cell.step().cpu().numpy()
        cpu = pnn_cell.make_cell(variant, shape, device="cpu",
                                 params=copy.deepcopy(cell.model).cpu())
        want = cpu.step().numpy()
        hold_logits(list(zip(got, want)), f"{variant} {CELL_PARITY_N}")


# ---------------------------------------------------------------------------
# LM serving.
# ---------------------------------------------------------------------------

def lm_hold_config(arch: str):
    """``config()`` at float32, one repetition of the pattern deep (an
    encoder of one layer)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.lm_config(arch, dtype="float32")
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                               encoder_layers=min(cfg.encoder_layers, 1))


def lm_prompt(cfg, batch: int, prompt: int, seed: int) -> dict:
    """A prefill's keyword inputs as host tensors, made with numpy."""
    import torch
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt)))
    if not cfg.encoder_layers:
        return {"tokens": toks}
    frames = (rng.standard_normal((batch, prompt, cfg.d_model)) * 0.1)
    return {"dec_tokens": toks,
            "frames": torch.from_numpy(frames.astype(np.float32))}


def lm_teacher_forced(runs, kw: dict, prompt: int, steps: int,
                      routes=None) -> list:
    """Prefill of ``kw`` and ``steps`` decode steps for each (model, cfg)
    of ``runs``, each on its model's device; the first run's greedy token
    feeds every run.  Returns per run the float32 logits (B, V) of the
    prefill and of each step.  A ``RouteLog`` given as ``routes`` files
    each run's routes under the run's index."""
    import torch
    from repro_torch.lm import model as M
    state, logits = [], [[] for _ in runs]
    for j, (model, cfg) in enumerate(runs):
        if routes is not None:
            routes.run = j
        dev = next(model.parameters()).device
        last, cache = M.prefill(model, cfg, max_len=prompt + steps,
                                **{k: v.to(dev) for k, v in kw.items()})
        state.append([last, cache])
        logits[j].append(last[:, 0].float().cpu().numpy())
    for i in range(steps):
        nxt = torch.argmax(state[0][0], -1).cpu()
        for j, (model, cfg) in enumerate(runs):
            if routes is not None:
                routes.run = j
            last, cache = state[j]
            state[j] = M.decode_step(model, cfg, nxt.to(last.device), cache,
                                     prompt + i)
            logits[j].append(state[j][0][:, 0].float().cpu().numpy())
    return logits


def card_copy(model, device: str = "cuda"):
    """``model`` on ``device``, copied one parameter at a time: the source
    side holds one copy of the weights, not two, and a block shared by
    several reps stays one block."""
    import copy
    import torch
    memo = {id(p): torch.nn.Parameter(p.detach().to(device),
                                      requires_grad=p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo)


def seeded_pair(cfg):
    """(the model on the CPU, the same weights on the card): drawn on the
    card from SEED (seconds where the CPU takes tens of them for the
    largest layers), then copied to the CPU."""
    import torch
    from repro_torch.lm import model as M
    card, _ = M.init(cfg, torch.Generator("cuda").manual_seed(SEED),
                     device="cuda")
    return card_copy(card, "cpu"), card


def phase_lm_hold():
    """Each architecture's prefill and teacher-forced decode logits, card
    against CPU on the same weights, by the serving rule (float32); then
    the bfloat16 holds."""
    import torch
    for arch, batch, prompt, steps in LM_HOLD:
        t0 = time.monotonic()
        cfg = lm_hold_config(arch)
        want_model, got_model = seeded_pair(cfg)
        want, got = lm_teacher_forced(
            [(want_model, cfg), (got_model, cfg)],
            lm_prompt(cfg, batch, prompt, SEED + 1), prompt, steps)
        n_params = sum(p.numel() for p in want_model.parameters())
        hold_logits(list(zip(got, want)),
                    f"LM {arch} (d_model {cfg.d_model}, {cfg.n_layers} "
                    f"layers {cfg.pattern}, {n_params / 1e9:.2f}B params, "
                    f"float32; prefill {batch}x{prompt} + {steps} decode "
                    f"steps, {time.monotonic() - t0:.1f} s)",
                    units=("logit sets", "rows"))
        del want_model, got_model
        torch.cuda.empty_cache()
    for row in LM_HOLD_BF16:
        phase_lm_hold_bf16(*row)


def rel_l2(got, want) -> float:
    """The largest relative L2 gap of a row (one sequence's logits)."""
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


class RouteLog:
    """Records the expert ids that every MoE layer's router chose (the
    output of ``moe._route``, the one function that makes them), under the
    index of the run that ``lm_teacher_forced`` is driving, in call order:
    the route a token took in each MoE layer of a prefill or a step."""

    def __init__(self):
        self.routes = {}
        self.run = None

    def __enter__(self):
        from repro_torch.lm import moe
        self.real = real = moe._route

        def logged(*args, **kw):
            out = real(*args, **kw)
            self.routes.setdefault(self.run, []).append(out[1].cpu())
            return out

        moe._route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.lm import moe
        moe._route = self.real

    def differ(self, a, b) -> tuple[int, int]:
        """(routes that differ, routes) between two runs' calls."""
        ra, rb = self.routes.get(a, []), self.routes.get(b, [])
        if len(ra) != len(rb):
            raise AssertionError(f"{len(ra)} MoE calls against {len(rb)}")
        return (sum(int((x != y).sum()) for x, y in zip(ra, rb)),
                sum(x.numel() for x in ra))


def phase_lm_hold_bf16(arch, batch, prompt, steps):
    """``arch`` at full config (published widths, full depth) in bfloat16
    activations: the card against the CPU on the same weights, held to
    LM_BF16_SLACK times the CPU's own bfloat16-vs-float32 gap; for a MoE
    architecture, how many (token, slot) routes differ between the two."""
    import dataclasses
    import torch
    from repro_torch import configs
    t0 = time.monotonic()
    cfg = configs.lm_config(arch)
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{arch}: config() serves in {cfg.dtype}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu, card = seeded_pair(cfg)
    with RouteLog() as log_:
        runs = lm_teacher_forced(
            [(cpu, cfg), (card, cfg), (cpu, cfg32)],
            lm_prompt(cfg, batch, prompt, SEED + 1), prompt, steps,
            routes=log_)
    # The padded vocabulary holds -1e30 on every side: the real one only.
    cpu16, card16, cpu32 = ([x[..., :cfg.vocab] for x in run] for run in runs)
    card_gap = max(rel_l2(g, w) for g, w in zip(card16, cpu16))
    dtype_gap = max(rel_l2(g, w) for g, w in zip(cpu16, cpu32))
    card_vs_32 = max(rel_l2(g, w) for g, w in zip(card16, cpu32))
    worst = max(float(np.abs(g - w).max()) for g, w in zip(card16, cpu16))
    finite = all(np.isfinite(g).all() for g in card16)
    routes = ""
    if cfg.moe is not None:
        n, total = log_.differ(1, 0)        # card vs CPU, bfloat16
        n32, _ = log_.differ(0, 2)          # the CPU's bfloat16 vs float32
        routes = (f"; (token, slot) routes differing card vs CPU: {n} of "
                  f"{total} ({cfg.n_layers} layers x (prefill + {steps} "
                  f"steps)); the CPU's bfloat16 vs float32: {n32}")
    log(f"LM {arch} bfloat16 (full config, {cfg.n_layers} layers; prefill "
        f"{batch}x{prompt} + {steps} decode steps, "
        f"{time.monotonic() - t0:.1f} s), card vs CPU: relative L2 "
        f"{card_gap:.4g} (max |d| {worst:.4g}); the CPU's bfloat16 vs "
        f"float32 {dtype_gap:.4g}, the card's {card_vs_32:.4g}; limit "
        f"{LM_BF16_SLACK} x {dtype_gap:.4g}{routes}")
    if not finite or not card_gap <= LM_BF16_SLACK * dtype_gap:
        raise AssertionError(f"LM {arch} bfloat16: card and CPU disagree")
    del cpu, card
    torch.cuda.empty_cache()


def phase_lm_serve(device: str = "cuda") -> dict:
    """The served architectures at full config on the card, through the
    launcher's greedy loop (``launch.serve.generate``) under the one-card
    mesh's logical rules: prefill, each decode step, peak memory, and one
    more step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.dist import elastic, logical
    from repro_torch.launch.serve import generate
    from repro_torch.lm import model as M
    mesh = elastic.make_mesh()
    rows = {}
    for arch, batch, prompt, new, layers in LM_SERVE:
        cfg = configs.lm_config(arch)
        cut = ""
        if layers is not None:
            cut = (f" (depth cut from {cfg.n_layers}: the weights of all "
                   f"{cfg.n_layers} layers do not fit one card)")
            cfg = configs.lm_config(arch, n_layers=layers)
        t0 = time.monotonic()
        model, _ = M.init(cfg, torch.Generator(device).manual_seed(SEED),
                          device=device)
        toks = torch.randint(0, cfg.vocab, (batch, prompt), device=device,
                             generator=torch.Generator(device).manual_seed(1))
        n_params = sum(p.numel() for p in model.parameters())
        log(f"LM serve {arch}: {cfg.n_layers} layers{cut}, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f}B params ({cfg.param_dtype}"
            f" weights, {cfg.dtype} activations), made on the card in "
            f"{time.monotonic() - t0:.1f} s, {mesh}")
        max_len = prompt + new + 1      # one slot more for the profiled step
        M.prefill(model, cfg, tokens=toks, max_len=max_len)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        marks, finite = [], []

        def on_step(logits):
            # The finiteness check is queued after the step's mark, so its
            # few small launches fall into the next step's time.
            torch.cuda.synchronize()
            marks.append(time.monotonic())
            finite.append(torch.isfinite(logits[..., :cfg.vocab]).all())

        ids, last, cache, prefill_s, _ = generate(
            model, cfg, toks, new, mesh, max_len=max_len, on_step=on_step)
        prefill_ms = prefill_s * 1e3
        steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if (not bool(torch.stack(finite).all())
                or int(ids.max()) >= cfg.vocab or len(steps_ms) != new):
            raise AssertionError(f"LM serve {arch}: non-finite logits or a "
                                 f"padded-vocab token")
        nxt = torch.argmax(last, -1)
        with logical.logical_rules(mesh, logical.RULES_V0), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            last, cache = M.decode_step(model, cfg, nxt, cache, prompt + new)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        prof_row = report_profile(prof, wall_us,
                                  f"LM serve {arch}: one decode step at "
                                  f"position {prompt + new}")
        step_ms = statistics.median(steps_ms)
        # The profiler slows the host: the idle share is read against the
        # unprofiled median step (the profiled step's own is beside it).
        idle = 1 - prof_row["busy_us"] / 1e3 / step_ms
        rows[arch] = {
            "batch": batch, "prompt": prompt, "new": new,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "tokens_per_s": batch * new / (sum(steps_ms) / 1e3),
            "prefill_tokens_per_s": batch * prompt / (prefill_ms / 1e3),
            "layers": cfg.n_layers, "params": n_params,
            "peak_gib": peak, "ops_per_step": prof_row["ops"],
            "busy_ms_per_step": prof_row["busy_us"] / 1e3,
            "idle_share": idle, "idle_share_profiled": prof_row["idle"]}
        log(f"LM serve {arch}: batch {batch}, prompt {prompt}: prefill "
            f"{prefill_ms:.2f} ms ({rows[arch]['prefill_tokens_per_s']:.0f} "
            f"tokens/s); {new} decode steps, median {step_ms:.3f} ms a step "
            f"(min {min(steps_ms):.3f}, max {max(steps_ms):.3f}), "
            f"{rows[arch]['tokens_per_s']:.1f} tokens/s; peak "
            f"{peak:.2f} GiB; device busy {prof_row['busy_us'] / 1e3:.2f} ms "
            f"a step, idle share {idle:.3f} of the median step "
            f"({prof_row['idle']:.3f} of the profiled one); logits finite; "
            f"first ids {ids[0, :8].tolist()}")
        if "slstm" in cfg.pattern:
            rows[arch]["slstm_layer"] = slstm_host_cost(model, cfg, batch,
                                                        prompt)
        del model, cache, last
        torch.cuda.empty_cache()
    log("LM serve: " + json.dumps(rows))
    return rows


def slstm_host_cost(model, cfg, batch: int, prompt: int) -> dict:
    """The sLSTM's share of a prefill: one sLSTM layer's forward over the
    prompt (one step a token, a Python loop), timed on the host clock and
    then under torch.profiler (device ops and busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.lm import xlstm
    i = cfg.pattern.index("slstm")
    block = model.blocks[i]
    dev = block.ln1.g.device
    x = torch.randn((batch, prompt, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(2)
                    ).to(cfg.act_dtype)

    def run():
        with torch.inference_mode():
            xlstm.slstm_forward(block.mix, x, d=cfg.d_model, cfg=cfg.xlstm)
        torch.cuda.synchronize()

    run()                                                   # warm-up
    t0 = time.monotonic()
    run()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        prof_wall_us = (time.monotonic() - t0) * 1e6
    row = report_profile(prof, prof_wall_us,
                         f"sLSTM layer {i}: forward over {batch}x{prompt}",
                         top=4)
    out = {"ms": wall_ms, "steps": prompt, "us_per_step": wall_ms * 1e3
           / prompt, "ops": row["ops"], "busy_ms": row["busy_us"] / 1e3}
    log(f"sLSTM layer {i} of {cfg.name}: {batch}x{prompt} in {wall_ms:.1f} "
        f"ms unprofiled ({out['us_per_step']:.1f} us a step, "
        f"{row['ops'] / prompt:.1f} device ops a step, device busy "
        f"{out['busy_ms']:.2f} ms); {cfg.pattern.count('slstm') * cfg.reps} "
        f"such layers a prefill")
    return out


# ---------------------------------------------------------------------------
# LM training.
# ---------------------------------------------------------------------------

def phase_lm_train_grads():
    """The first training step's gradients of LM_GRAD_ARCHS (one
    repetition, float32, published widths) on the card against the CPU on
    the same weights and tokens, by ``checks.hold_grads`` (a parameter all
    zero on the CPU must be all zero on the card)."""
    import torch
    from repro_torch.kernels import checks
    from repro_torch.launch.train import make_batch
    from repro_torch.lm import steps
    for arch in LM_GRAD_ARCHS:
        t0 = time.monotonic()
        cfg = lm_hold_config(arch)
        cpu, card = seeded_pair(cfg)
        runs = []
        for model, dev in ((cpu, "cpu"), (card, "cuda")):
            grads, loss, aux = steps.grads_fn(model, cfg)(
                steps.param_dict(model),
                make_batch(cfg, SEED, 0, 1, LM_GRAD_TOKENS, dev))
            runs.append((grads, float(loss), float(aux)))
        (want, wl, wa), (got, gl, ga) = runs
        rel = checks.hold_grads(got, want, zero_ok=True)
        zero = sum(1 for g in want.values() if not bool(g.abs().sum() > 0))
        worst = max(rel, key=rel.get)
        log(f"LM gradients {arch} ({cfg.n_layers} layers {cfg.pattern}, "
            f"d_model {cfg.d_model}, float32, 1x{LM_GRAD_TOKENS} tokens), "
            f"card vs CPU: loss {gl:.7f} vs {wl:.7f}, aux {ga:.7f} vs "
            f"{wa:.7f}; {len(got)} parameters, all finite, largest "
            f"relative L2 {rel[worst]:.3g} ({worst}; rule <= "
            f"{checks.GRAD_REL_TOL}); {zero} all zero on the CPU and on the "
            f"card; {time.monotonic() - t0:.1f} s")
        del cpu, card, runs, got, want
        torch.cuda.empty_cache()


def lm_train_argv(steps: int, *extra) -> list:
    b, s, mb = LM_TRAIN_SHAPE
    return ["--arch", LM_TRAIN_ARCH, "--full-config", "--batch", str(b),
            "--seq", str(s), "--microbatch", str(mb), "--steps", str(steps),
            *extra]


def lm_train_profile(run: dict, median_s: float) -> dict:
    """Two more steps of the timed run (``launch.train.main``'s train step,
    parameters and optimizer state, on its batch 0), one counted (FLOPs,
    bytes) and one under torch.profiler: the model-flops share,
    usefulness and the card's idle share against the run's median step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    b, s, mb = LM_TRAIN_SHAPE
    cfg, step = run["cfg"], run["train_step"]
    params, state = run["params"], run["opt_state"]
    batch = run["next_batch"](0)

    def one():
        return float(step(params, state, batch)[2]["loss"])

    counts = dryrun.count(one)
    model_flops = rl.model_flops_for(cfg, "train", s, b,
                                     rl.active_params(cfg, run["model"]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        one()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    row = report_profile(prof, wall_us, f"profile LM train step "
                         f"{LM_TRAIN_ARCH} ({b}x{s}, microbatch {mb})",
                         top=10)
    return {"model_flops": model_flops, "counted_flops": counts["flops"],
            "counted_bytes": counts["bytes"],
            "usefulness": model_flops / counts["flops"],
            "mfu_bf16": model_flops / (median_s * rl.PEAK_FLOPS_BF16),
            "ops": row["ops"], "busy_ms": row["busy_us"] / 1e3,
            "idle_share": 1 - row["busy_us"] / 1e6 / median_s,
            "idle_share_profiled": row["idle"]}


def phase_lm_train() -> dict:
    """``launch.train``'s entry point at full config: TRAIN_STEPS steps
    (falling loss; median step, tokens/s, peak memory, model-flops share,
    one profiled step); a checkpointed run and its rerun (a resume at the
    checkpoint's step); int8 compression."""
    import tempfile
    import torch
    from repro_torch.launch import train as launch_train
    b, s, mb = LM_TRAIN_SHAPE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    info = launch_train.main(lm_train_argv(TRAIN_STEPS), log=log)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in info["history"]]
    dts = [h["dt"] for h in info["history"]]
    hold_losses(losses, f"LM training {LM_TRAIN_ARCH}")
    med = statistics.median(dts)
    prof = lm_train_profile(info, med)
    del info
    torch.cuda.empty_cache()
    row = {"arch": LM_TRAIN_ARCH, "batch": b, "seq": s, "microbatch": mb,
           "steps": len(losses), "wall_s": wall, "median_step_ms": med * 1e3,
           "first_step_ms": dts[0] * 1e3, "tokens_per_s": b * s / med,
           "peak_gib": peak, **prof}
    log(f"LM training {LM_TRAIN_ARCH} full config, {b}x{s} (microbatch "
        f"{mb}): {len(losses)} steps in {wall:.1f} s, median step "
        f"{med * 1e3:.1f} ms (first {dts[0] * 1e3:.1f} ms), "
        f"{row['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB; "
        f"usefulness {prof['usefulness']:.3f} (model flops "
        f"{prof['model_flops']:.4g} / counted {prof['counted_flops']:.4g}), "
        f"model-flops share of the bf16 peak {prof['mfu_bf16']:.4f}; "
        f"profiled step: {prof['ops']} device ops, busy "
        f"{prof['busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f} of "
        f"the median step")
    log("LM losses: " + " ".join(f"{x:.4f}" for x in losses))
    log("LM step ms: " + " ".join(f"{x * 1e3:.1f}" for x in dts))
    with tempfile.TemporaryDirectory() as ckpt:
        launch_train.main(lm_train_argv(LM_CKPT_STEPS, "--ckpt", ckpt),
                          log=log)
        seen = []

        def keep(msg):
            seen.append(msg)
            log(msg)

        again = launch_train.main(
            lm_train_argv(LM_RESUME_STEPS, "--ckpt", ckpt), log=keep)
    resumed = [h["loss"] for h in again["history"]]
    want = f"[loop] restored step {LM_CKPT_STEPS}, resuming at " \
        f"{LM_CKPT_STEPS}"
    if want not in seen or len(resumed) != LM_RESUME_STEPS - LM_CKPT_STEPS \
            or not np.isfinite(resumed).all():
        raise AssertionError(f"LM resume: {seen[-3:]}, losses {resumed}")
    log(f"LM resume: restored at step {LM_CKPT_STEPS}, steps "
        f"{[h['step'] for h in again['history']]}, losses {resumed}")
    del again
    torch.cuda.empty_cache()
    int8 = launch_train.main(
        lm_train_argv(LM_INT8_STEPS, "--compression", "int8"), log=log)
    q = [h["loss"] for h in int8["history"]]
    qdt = statistics.median(h["dt"] for h in int8["history"])
    del int8
    if len(q) != LM_INT8_STEPS or not np.isfinite(q).all():
        raise AssertionError(f"LM int8 training: losses {q}")
    row["int8_median_step_ms"] = qdt * 1e3
    log(f"LM training with int8 compression: {len(q)} steps, losses "
        f"{' '.join(f'{x:.4f}' for x in q)}, median step {qdt * 1e3:.1f} ms "
        f"against {med * 1e3:.1f} ms uncompressed")
    torch.cuda.empty_cache()
    return row


def phase_lm_cells() -> list:
    """LM_CELLS through ``launch.dryrun.run_cell`` on the card, each row
    with its cuts."""
    import torch
    from repro_torch.launch import dryrun
    rows = []
    for arch, shape, batch in LM_CELLS:
        d = dryrun.run_cell(arch, shape, batch=batch, reps=LM_CELL_REPS)
        keep = ("arch", "shape", "kind", "batch", "ref_batch", "microbatch",
                "reps", "ref_reps", "reduced", "step_s", "warm_s",
                "hlo_flops_per_chip", "hlo_bytes_per_chip", "model_flops",
                "n_params", "n_active", "run_params", "usefulness",
                "bottleneck", "bound_fraction", "probe")
        row = {k: d[k] for k in keep}
        row["peak_gib"] = d["mem_per_device"]["peak_mb"] / 1024
        log(f"LM cell row: {json.dumps(row)}")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# The multi-card PNN path (phase 17).
# ---------------------------------------------------------------------------

def phase_mesh(model_axes=MESH_MODEL_AXES, measure: bool = False) -> list:
    """``repro_torch.launch.mesh_smoke`` under torchrun, one process a card
    of this machine, once per model axis (``measure``: with the numbers
    PERF.md keeps); its ranks check themselves and rank 0 prints
    ``MESH_RESULT``.  A rank's failure, or a run past ``MESH_TIMEOUT_S``
    (its process group is killed), raises.  Returns the results."""
    import torch
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    rows = []
    for m in model_axes:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "-m", "repro_torch.launch.mesh_smoke",
               "--model-axis", str(m)] + (["--measure"] if measure else [])
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            log(out[-4000:])
            raise AssertionError(f"mesh run on {n} cards (model axis {m}) "
                                 f"past {MESH_TIMEOUT_S} s")
        wall = time.monotonic() - t0
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("MESH_RESULT ")]
        if proc.returncode != 0 or not lines:
            log(out[-6000:])
            raise AssertionError(f"mesh run on {n} cards (model axis {m}) "
                                 f"exited {proc.returncode}")
        res = json.loads(lines[-1][len("MESH_RESULT "):])
        sv, tr, sc = res["serving"], res["training"], res["scene"]
        log(f"mesh {res['mesh']} over {res['world']} {res['backend']} "
            f"ranks ({res['card']}), {wall:.1f} s with the start: serving "
            f"{sv['requests']} requests, {sv['rule']['over']} of "
            f"{sv['rule']['points']} points over {LOGIT_TOL} against one "
            f"card (max |d| {sv['rule']['max_abs']:.3g}); training losses "
            f"max |d| {tr['none']['max_abs']:.3g} plain, "
            f"{tr['int8']['max_abs']:.3g} int8 against one card, "
            f"parameters identical on every rank; {sc['points']}-point "
            f"scene in {sc['infer_s']:.2f} s on every rank alike; launches "
            f"on rank 0: serving {sv['launches'][0]}, training "
            f"{tr['none']['launches'][0]}")
        log("MESH " + json.dumps(res))
        rows.append(res)
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    phase_analysis(smi)
    phase_ladder("cuda")
    engine = make_engine(None)
    log(f"warm: {engine.warm()}")
    # Kernel inputs come from an engine of its own (same weights), so the
    # serving engine's latency and throughput cover the served stream only.
    rows = phase_main_path_kernels(make_engine(None, params=engine.params))
    clouds, results, launches = phase_serve(engine)
    phase_cpu_reference(engine, clouds, results)
    phase_289k(engine)
    phase_profile(engine)
    rows.update(phase_level_kernel())
    partition_rows = phase_partition()
    xl_rows, xl_launches = phase_invres_xl()
    pt_rows, pt_launches = phase_point_transformer()
    blend_rows = phase_interp_blend()
    phase_global(engine)
    scene_launches = phase_scene(engine.params)
    del engine
    example_launches = phase_examples()
    phase_grad_parity(PARITY_N, 1)
    phase_grad_parity(TRAIN_N, TRAIN_BATCH)
    cfg, model, state, train_launches, plain_ms = phase_train()
    rows.update(phase_train_kernels(cfg, model))
    launches["scatter_add_blocks"] = train_launches["scatter_add_blocks"]
    phase_profile_train(cfg, model, state)
    del model, state
    compressed = phase_train_compressed(plain_ms)
    cells, cell_batch = phase_cells()
    phase_profile_cell(cell_batch)
    phase_cell_parity()
    phase_compressed_grads(PARITY_N, 1)
    phase_lm_hold()
    phase_lm_serve()
    phase_lm_train_grads()
    phase_lm_train()
    phase_lm_cells()
    phase_mesh()

    kernels = []
    for name in REPLACES:
        r = rows[name]
        bms, by = bound_ms(r["bytes"], r["ops"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": r["library_ms"]})
    log(f"(kernel ms, plain_ms, bound_ms, library_ms: sums over the calls "
        f"of the {MICROBATCH}x{BUCKETS[-1]} serving microbatch, for "
        f"scatter_add_blocks of one {TRAIN_BATCH}x{TRAIN_N} training step, "
        f"and for fractal_level_blocks one call on that microbatch's leaf "
        f"blocks, (da, db) = {LEVEL_DIMS_TIMED}; launches: the serving run "
        f"(for scatter_add_blocks the {TRAIN_STEPS} training steps; "
        f"fractal_level_blocks is on no path), also for the partition, "
        f"whose rows give a call's launches apart; launches on the other paths, "
        f"each read around its own run: the compressed trainings "
        f"{compressed}, the PNN cells' timed steps {cells}, the 1M scene's "
        f"inference {scene_launches}, the thin clients' runs "
        f"{example_launches}; card: {smi}; total "
        f"{time.monotonic() - t_start:.1f} s)")
    print(json.dumps({"kernels": kernels, "partition": {
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/partition.cu",
        "launches": launches["partition"], "calls": partition_rows},
        "pointnext_xl": {"launches": xl_launches, "kernels": xl_rows},
        "point_transformer": {"launches": pt_launches, "kernels": pt_rows},
        "interp_blend": blend_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
