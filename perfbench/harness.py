"""What every cell's run shares: finding its files by name, the weights
and the device, the traced window, the per-layer readers and the result
line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  Its
files are found by those names alone:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix's parameters, whose ``entry`` names
  the driver of the window, ``entries/<entry>.py``;
* ``limits/<cell>.json``: the limit of each number the cell compares;
* ``metrics/<metric>.py``: one reader a per-layer metric, ``read(record)``
  returning a number or None where it finds nothing to read.

So a later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent   # the checkout
HERE = Path(__file__).resolve().parent

# Top-level module names a run may not hold once its window has closed:
# the JAX package, JAX itself, and the JAX package's own benchmarks.
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_of(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def load_file(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_of(traffic: dict):
    return load_file(HERE / "entries" / f"{traffic['entry']}.py",
                     f"perfbench_entry_{traffic['entry']}")


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    that list it, and those without a list whose moved metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_per_layer(metrics: list, record: dict) -> dict:
    """{name: {value, unit}} of each per-layer metric whose reader finds
    something in ``record``."""
    out = {}
    for m in metrics:
        reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                           "perfbench_metric_" + m["name"].replace(".", "_")
                           .replace("-", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``BANNED``, compared whole."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".", 1)[0] in BANNED})


# ---------------------------------------------------------------------------
# Weights, made from the seed on the device.
# ---------------------------------------------------------------------------

def make_weights(shapes: list, seed: int, device) -> dict:
    """{name: tensor} for [(name, shape)] from one draw of a generator on
    ``device`` seeded with ``seed``: a dense weight ``w`` (din, dout) is
    normal at Glorot's scale sqrt(2 / (din + dout)), a LayerNorm gain
    1 + 0.1 * normal, every bias and LayerNorm shift 0.1 * normal."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(_numel(s) for _, s in shapes)
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        k = _numel(shape)
        x = flat[at:at + k].view(shape)
        at += k
        if name.endswith(".w"):
            x = x * (2.0 / (shape[0] + shape[1])) ** 0.5
        elif name.endswith(".g"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def _numel(shape) -> int:
    k = 1
    for d in shape:
        k *= d
    return k


# ---------------------------------------------------------------------------
# The run's context and result.
# ---------------------------------------------------------------------------

class Context:
    """What an entry gets: the cell, its configuration and mix, the seed,
    the window length, whether to trace, the device, the number of chips
    and the process's start on the host clock."""

    def __init__(self, *, cell, config, traffic, seed, seconds, trace,
                 device, chips, t_start):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.chips, self.t_start = device, chips, t_start

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def clock(self) -> float:
        return time.monotonic()

    def peak_bytes(self) -> int:
        """The device's peak allocation so far (0 on the CPU)."""
        if not self.on_card:
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        """Return what the program left in the allocator's cache."""
        import gc
        gc.collect()
        if self.on_card:
            import torch
            torch.cuda.empty_cache()


def subseed(seed: int, *words) -> int:
    """A 63-bit seed derived from ``seed`` and ``words``."""
    import numpy as np
    return int(np.random.SeedSequence([seed % 2**63, *words])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def checks_of(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of each number compared, every one with
    its limit (a missing limit is an error of the benchmark)."""
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in readings.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
