"""Perf hillclimb: re-run a cell under named variants and report the
roofline terms of each beside the baseline's.

Counterpart of ``repro.launch.perf``, under its variant names.  A
variant here changes what one card computes (a config knob, the PNN leaf
chunk or point ops), so its row is comparable with the baseline row of
the same cell.  The reference's other variants change only a sharding
rule, the MoE dispatch (``grouped_a2a``) or ``remat``, which have no
counterpart on one card: asking for one raises ``ValueError``
(``REFUSED``).  Unlike the reference's ``main``, a variant that fails
makes the run exit non-zero.

  PYTHONPATH=src python -m repro_torch.launch.perf \\
      --cell smollm-135m:train_4k --variants baseline,flash4k --out rows.json
  PYTHONPATH=src python -m repro_torch.launch.perf \\
      --cell pointnext:pnn_289k --variants baseline,chunk2k,global_ops
"""
from __future__ import annotations

import argparse
import json
import traceback

from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.pnn_cell import PNN_VARIANTS, run_pnn_cell

VARIANTS = {
    # paper/v0 baseline
    "baseline": lambda arch: {},
    # H4: larger flash chunk (fewer chunk steps, bigger tiles).
    "flash4k": lambda arch: {"cfg_overrides": {"flash_chunk": 4096}},
}

PNN_VARIANTS_PERF = {
    # v0 baseline: leaf-chunked ops
    "baseline": {},
    # H-P2: bigger leaf chunks (fewer chunk steps <-> larger live tiles).
    "chunk2k": {"leaf_chunk": 2048},
    # H-P3: paper-baseline global ops (PointAcc-style) for the BPPO
    # speedup comparison.
    "global_ops": {"point_ops": "global", "batch": 16},
}

_A2A = "the MoE dispatch (grouped_a2a)"
REFUSED = {
    "a2a_moe": _A2A,
    "dp_only": "the sharding rules",
    "no_remat": "remat",
    "dp_no_remat": "the sharding rules and remat",
    "a2a_mb2": _A2A,
    "a2a_mb8": _A2A,
    "a2a_bf16": _A2A,
    "points_sharded": "the sharding rules",
    "blocks_all": "the sharding rules",
}


def run_variant(arch, shape, variant, device=None):
    """The row of ``arch`` x ``shape`` under ``variant``, with
    ``row["variant"]``; a variant of ``REFUSED`` raises ``ValueError``."""
    if variant in REFUSED:
        raise ValueError(f"variant {variant!r} changes only "
                         f"{REFUSED[variant]}, which has no counterpart on "
                         f"one card")
    if arch in PNN_VARIANTS:
        row = run_pnn_cell(arch, shape, device=device,
                           **PNN_VARIANTS_PERF[variant])
    else:
        row = run_cell(arch, shape, device=device, **VARIANTS[variant](arch))
    row["variant"] = variant
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    rows = []
    for v in args.variants.split(","):
        try:
            rows.append(run_variant(arch, shape, v, args.device))
        except Exception as e:  # noqa: BLE001 - reported; the exit fails
            traceback.print_exc()
            rows.append({"arch": arch, "shape": shape, "variant": v,
                         "error": str(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    for r in rows:
        if "error" in r:
            print(f"{r['variant']}: ERROR {r['error'][:120]}")
            continue
        print(f"{r['variant']:12s} step={r['step_s']*1e3:9.2f}ms "
              f"t_comp={r['t_compute_s']*1e3:9.2f}ms "
              f"t_mem={r['t_memory_s']*1e3:9.2f}ms "
              f"t_coll={r['t_collective_s']*1e3:9.2f}ms "
              f"bound={r['bottleneck']:10s} useful={r['usefulness']*100:5.1f}% "
              f"peak={r['mem_per_device']['peak_mb']/1024:6.2f}GB")
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
