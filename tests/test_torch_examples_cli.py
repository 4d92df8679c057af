"""Each thin client of ``repro_torch.examples`` run as ``python -m
repro_torch.examples.<name> --device cpu`` at a small size, in a process
of its own: it exits 0 and prints the reference client's lines."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

RUNS = {
    "quickstart": ([], ["partitioned 4096 points -> ", "sampled ",
                        "grouping: mean ", "neighbor recall vs global"]),
    "serve_pnn": (["--buckets", "128,256", "--th", "64", "--requests", "4",
                   "--microbatch", "2", "--variant", "pointnet2"],
                  ["warmed 2 buckets", "served 4 clouds",
                   "  bucket n=", "(one trace per key: True)"]),
    "segment_scene": (["--n", "2048", "--tile-points", "512", "--th", "64"],
                      ["scene: 2048 points", "tiled: ", "inferred: ",
                       "owned by one tile: True", "peak RSS "]),
    "train_pointnet": (["--steps", "2", "--batch", "2", "--n-points", "128",
                        "--th", "32"],
                       ["step    0 loss ", "FINAL [bppo] accuracy: "]),
    "lm_pretrain_smoke": (["--steps", "2", "--batch", "2", "--seq", "16"],
                          ["[loop] step 0 loss ",
                           "[smollm-135m-reduced] loss "]),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_client_runs_as_a_module_on_the_cpu(name, tmp_path):
    argv, lines = RUNS[name]
    if name == "lm_pretrain_smoke":
        argv = argv + ["--ckpt", str(tmp_path / "ckpt")]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *argv,
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for want in lines:
        assert want in proc.stdout, (want, proc.stdout)
