"""Run the PNN cells on one card and print their roofline table.

Counterpart of the PNN branch of ``repro.launch.dryrun``, which lowers
the cells for a TPU pod; here each cell runs (``pnn_cell.run_pnn_cell``).
The LM cells wait for the port of ``lm/`` and ``configs/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch pointnext \\
        --shape pnn_289k [--train] [--batch 4] [--out rows.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Without ``--batch`` a cell on the card takes the largest batch up to the
reference's that fits (``pnn_cell.fit_batch``).  ``--device cpu`` runs the
plain versions (small shapes only).  A cell that fails ends the run with
a non-zero exit, after the rows done so far are written to ``--out``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import roofline as rl
from repro_torch.launch.pnn_cell import PNN_SHAPES, PNN_VARIANTS, run_pnn_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help=f"one of {sorted(PNN_VARIANTS)}")
    ap.add_argument("--shape", default=None,
                    help=f"one of {sorted(PNN_SHAPES)}")
    ap.add_argument("--all", action="store_true",
                    help="the three variants at pnn_289k")
    ap.add_argument("--train", action="store_true",
                    help="run the fine-tune step (gradient through the "
                         "point ops + AdamW) instead of the serving step")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(variant, "pnn_289k") for variant in PNN_VARIANTS]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    for arch, shape in cells:
        if arch not in PNN_VARIANTS:
            raise ValueError(
                f"--arch {arch!r}: only the PNN cells {sorted(PNN_VARIANTS)} "
                f"are ported; the LM archs wait for lm/ and configs/ "
                f"(ROADMAP.md A6) and the LM cells of launch/ (ROADMAP.md A7)")
        if shape not in PNN_SHAPES:
            raise ValueError(f"--shape {shape!r}: have {sorted(PNN_SHAPES)}")

    rows = []
    for arch, shape in cells:
        rows.append(run_pnn_cell(arch, shape, batch=args.batch,
                                 kind="train" if args.train else "serve",
                                 device=args.device))
        if args.out:  # incremental: a failed cell keeps the rows before it
            with open(args.out, "w") as f:
                json.dump({"rows": rows}, f, indent=1)
    print(rl.format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
