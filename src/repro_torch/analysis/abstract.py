"""Interface checks: output specs across devices and chunks, and launch
budgets of the CUDA kernels.

Counterpart of ``repro.analysis.abstract``.  The numeric tests prove the
kernels compute the right values; this layer proves the interfaces agree
and that every launch fits the card, at shapes no numeric test need run:

* **ABS001 parity**: every public op of ``kernels/ops.py`` gives the same
  output shapes and dtypes chunked and unchunked, and on the card the
  kernel branch gives the specs of the CPU branch (each wrapper allocates
  its own outputs).  The device takes the place of the reference's
  ``impl=``.
* **ABS002 oracle**: the public op's specs equal those of its kernel
  module's plain version called directly at the caller's shapes
  (``fps_plain``, ``knn_plain``, ...: the port's ``kernels/ref.py``).
* **ABS003 geometry**, in place of BlockSpec divisibility and (8, 128)
  alignment: each launch's threads are whole warps and at most the
  function's ``maxThreadsPerBlock`` (which reflects its registers), and
  its grid is within the device's limits.
* **ABS004 footprint**, in place of the VMEM budget: static plus dynamic
  shared memory within ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (227 KB
  on an H100), and no register spilled to local memory.

On the CPU, ABS001/ABS002 run under ``FakeTensorMode`` (shapes only, no
data); on the card the kernel branch runs on real tensors at the
matrix's sizes.  ABS003/ABS004 read the launch geometry from the
launchers themselves: each ``csrc/*.cu`` computes it in one host function
that both its launch entry and its ``fc_*_geometry`` query entry call, and
``fc_*_attributes`` returns a kernel variant's ``cudaFuncGetAttributes``.
They need the built library, so they run on the card only;
``check_launch`` itself is plain Python.

Shapes in the matrix are deliberately not warp-aligned (33, 65, 200 ...).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import inspect

from repro_torch.analysis.report import ERROR, Finding

CHUNKS = (None, 2)

# The shape ladder: (nb blocks, block size, samples k, neighbours num,
# window w, gather rows m, channels c).  Mixed misaligned sizes.
MATRIX = (
    dict(nb=1, bs=33, k=8, num=8, w=200, m=40, c=3),
    dict(nb=3, bs=65, k=16, num=8, w=128, m=64, c=35),
    dict(nb=2, bs=256, k=64, num=32, w=512, m=256, c=64),
)

CSRC = "src/repro_torch/kernels/csrc/"

# family -> (source, kernel of each variant index), as the
# fc_<family>_geometry / fc_<family>_attributes entries number them.
LAUNCHERS = {
    "fps_warp": ("fps.cu",
                 tuple(f"fps_warp_kernel<{s}>" for s in (1, 2, 4, 8, 16))),
    "fps_cta": ("fps.cu", tuple(f"fps_kernel<{p}>" for p in (1, 2, 8))),
    "fps_wide": ("fps.cu", ("fps_wide_kernel",)),
    "ball_query": ("ball_query.cu", tuple(f"ball_query_kernel<{c}>"
                                          for c in (1, 2, 4, 8, 16, 32))),
    "knn": ("knn.cu", tuple(f"knn_kernel<{c}>" for c in (1, 2, 4, 8, 16, 32))),
    "gather": ("gather.cu", ("gather_kernel<float4>", "gather_kernel<float>")),
    "scatter_add": ("scatter_add.cu", ("scatter_add_kernel",)),
    "fractal_level": ("fractal_level.cu", ("fractal_level_kernel",)),
    "partition": ("partition.cu", ("partition_init_kernel",
                                   "partition_count_kernel",
                                   "partition_scatter_kernel",
                                   "partition_slots_kernel",
                                   "partition_final_kernel")),
    "local_aggregate": ("local_aggregate.cu",
                        ("local_aggregate_kernel<float4>",
                         "local_aggregate_kernel<float>")),
    "interp_blend": ("interp_blend.cu",
                     ("interp_blend_kernel<float4>",
                      "interp_blend_kernel<float>")),
    "vector_attention": ("vector_attention.cu",
                         ("vector_attention_kernel<4>",
                          "vector_attention_kernel<8>",
                          "vector_attention_kernel<16>",
                          "vector_attention_rows2_kernel<16>")),
}

# The largest shapes the paths launch (PERF.md's main-path rows and the PNN
# cells' leaf chunks of 8192 blocks), and widths that reach every variant:
# FPS at 32-20,000 lanes, ball query and kNN at every list length and
# over a 20,000-lane window.  Each row: family -> geometry arguments.
PATH_SHAPES = (
    *(("fps", (nb, bs, 65)) for nb in (10204, 8192)
      for bs in (32, 64, 128, 256, 512, 513, 2048, 8192, 8193, 20000)),
    *(("ball_query", (nb, 65, 512, 16)) for nb in (10204, 2524, 8192)),
    *(("ball_query", (64, 65, w, num)) for w in (512, 20000)
      for num in (1, 2, 3, 8, 16, 32, 40)),
    *(("knn", (nb, 256, 128, 3)) for nb in (10204, 2524, 8192)),
    *(("knn", (64, 256, w, k)) for w in (128, 20000)
      for k in (1, 2, 8, 16, 40)),
    *(("gather", (nb, w, c, 768, al)) for al in (1, 0)
      for nb, w, c in ((2524, 128, 128), (10204, 128, 64), (8192, 512, 128))),
    *(("scatter_add", (nb, 768, c, w))
      for nb, w, c in ((5048, 128, 64), (1208, 128, 128), (8192, 512, 128))),
    *(("fractal_level", (nb, 256)) for nb in (10204, 8192)),
    # The partition's five stages (B, n, depth, stage): a blocks
    # microbatch's stages 0-2, a rooms microbatch's stages 0-1, a 1M-point
    # scene's one coarse partition.
    *(("partition", (b, n, depth, stage))
      for b, n, depth in ((4, 4096, 13), (4, 1024, 11), (4, 256, 0),
                          (8, 289000, 18), (8, 72250, 18), (1, 1000000, 17))
      for stage in range(5)),
    # PointNeXt-XL's four block stages (4 rooms: B, m, C, ns, aligned) and
    # the float variant at the first.
    *(("local_aggregate", (4, m, c, 32, 1))
      for m, c in ((72250, 128), (18062, 256), (4516, 512), (1129, 1024))),
    ("local_aggregate", (4, 72250, 128, 32, 0)),
    # The FP stages' blend (NB, bs, C, aligned): a PointNeXt-XL microbatch's
    # four levels (4 rooms, 1024/512/256/128 channels onto levels 3-0), a
    # rooms microbatch's level 0 (8 rooms, 64 channels), and the float
    # variant at an odd width.
    *(("interp_blend", (4 * ml, 256, c, 1))
      for ml, c in ((185, 1024), (758, 512), (3041, 256), (9916, 128))),
    ("interp_blend", (8 * 9916, 256, 64, 1)),
    ("interp_blend", (8 * 9916, 256, 33, 1)),
    # Point Transformer's attention at each level of a 16-room microbatch
    # (B, m, C, k, N = C / 8): every tiling of the kernel.
    *(("vector_attention", (16, m, c, k, c // 8))
      for m, c, k in ((289000, 32, 8), (72250, 64, 16), (18062, 128, 16),
                      (4516, 256, 16), (1129, 512, 16))),
)


@dataclasses.dataclass(frozen=True)
class OpCase:
    """One public op's interface: how to call it and what its plain
    version says."""

    name: str
    wrapper: object        # the kernels/ops.py public function
    make_inputs: object    # (dims, device) -> input tensors, caller layout
    call: object           # (inputs, chunk, dims) -> the op's outputs
    oracle: object         # (inputs, dims) -> the plain version's outputs


def _specs(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype))
    return tuple(_specs(t) for t in tree)


def _loc(wrapper):
    """(path, line) of a public wrapper, repo-relative when possible."""
    path = inspect.getsourcefile(wrapper) or "<unknown>"
    marker = "src/repro_torch/"
    if marker in path:
        path = marker + path.split(marker, 1)[1]
    try:
        line = inspect.getsourcelines(wrapper)[1]
    except OSError:
        line = 1
    return path, line


def _dims_str(dims: dict) -> str:
    return "[" + ",".join(f"{k}={v}" for k, v in sorted(dims.items())) + "]"


def _mode(device):
    """Shapes only on the CPU; real tensors on the card, so the kernel
    branch runs."""
    if device.type == "cpu":
        from torch._subclasses.fake_tensor import FakeTensorMode

        return FakeTensorMode()
    return contextlib.nullcontext()


def build_cases() -> tuple:
    """The op table.  Imported lazily, so a lint-only run never imports
    torch."""
    import torch

    from repro_torch.kernels import ball_query as _bq
    from repro_torch.kernels import fps as _fps
    from repro_torch.kernels import fractal_level as _fl
    from repro_torch.kernels import gather as _ga
    from repro_torch.kernels import knn as _knn
    from repro_torch.kernels import ops

    def pts(d, n, dev):
        return torch.rand((d["nb"], n, 3), device=dev)

    def mask(d, n, dev):
        return torch.rand((d["nb"], n), device=dev) > 0.3

    def gather_call(inp, chunk, d):
        feats, idx = inp
        feats = feats.detach().requires_grad_()
        out = ops.gather_blocks(feats, idx, chunk=chunk)
        (grad,) = torch.autograd.grad(out, feats, torch.ones_like(out))
        return out, grad

    def gather_oracle(inp, d):
        feats, idx = inp
        return (_ga.gather_plain(feats, idx),
                _ga.scatter_add_plain(
                    feats.new_ones((d["nb"], d["m"], d["c"])), idx,
                    w=d["w"]))

    return (
        OpCase(
            name="fps_blocks", wrapper=ops.fps_blocks,
            make_inputs=lambda d, dev: (pts(d, d["bs"], dev),
                                        mask(d, d["bs"], dev)),
            call=lambda inp, chunk, d: ops.fps_blocks(*inp, k=d["k"],
                                                      chunk=chunk),
            oracle=lambda inp, d: _fps.fps_plain(*inp, d["k"])),
        OpCase(
            name="ball_query_blocks", wrapper=ops.ball_query_blocks,
            make_inputs=lambda d, dev: (pts(d, d["k"], dev),
                                        mask(d, d["k"], dev),
                                        pts(d, d["w"], dev),
                                        mask(d, d["w"], dev)),
            call=lambda inp, chunk, d: ops.ball_query_blocks(
                *inp, radius=0.3, num=d["num"], chunk=chunk),
            oracle=lambda inp, d: _bq.ball_query_plain(
                *inp, radius=0.3, num=d["num"])),
        OpCase(
            name="knn_blocks", wrapper=ops.knn_blocks,
            make_inputs=lambda d, dev: (pts(d, d["m"], dev),
                                        pts(d, d["w"], dev),
                                        mask(d, d["w"], dev)),
            call=lambda inp, chunk, d: ops.knn_blocks(*inp, k=3,
                                                      chunk=chunk),
            oracle=lambda inp, d: _knn.knn_plain(*inp, k=3)),
        # gather_blocks, forward and its scatter_add_blocks backward.
        OpCase(
            name="gather_blocks", wrapper=ops.gather_blocks,
            make_inputs=lambda d, dev: (
                torch.rand((d["nb"], d["w"], d["c"]), device=dev),
                torch.randint(-1, d["w"] + 1, (d["nb"], d["m"]),
                              dtype=torch.int32, device=dev)),
            call=gather_call, oracle=gather_oracle),
        OpCase(
            name="fractal_level_blocks", wrapper=ops.fractal_level_blocks,
            make_inputs=lambda d, dev: (pts(d, d["bs"], dev),
                                        mask(d, d["bs"], dev),
                                        torch.rand((d["nb"],), device=dev)),
            call=lambda inp, chunk, d: ops.fractal_level_blocks(
                *inp, da=0, db=1, chunk=chunk),
            oracle=lambda inp, d: _fl.fractal_level_plain(*inp, da=0,
                                                          db=1)),
    )


def check_case(case: OpCase, dims: dict, devices=None) -> list:
    """ABS001 and ABS002 for one (op, shape row) cell, over ``devices``
    (default: the CPU alone) x ``CHUNKS``."""
    import torch

    devices = [torch.device(d) for d in (devices or ("cpu",))]
    path, line = _loc(case.wrapper)

    def finding(rule, msg):
        return Finding(path=path, line=line, rule=rule, severity=ERROR,
                       message=f"{case.name}{_dims_str(dims)}: {msg}")

    out, got = [], {}
    for dev in devices:
        for chunk in CHUNKS:
            try:
                with _mode(dev):
                    got[(dev.type, chunk)] = _specs(
                        case.call(case.make_inputs(dims, dev), chunk, dims))
            except Exception as e:  # the call itself failed
                out.append(finding(
                    "ABS001", f"failed on {dev.type} chunk={chunk}: "
                    f"{type(e).__name__}: {e}"))
    if out:
        return out
    base_key = (devices[0].type, None)
    base = got[base_key]
    for key, specs in got.items():
        if specs != base:
            out.append(finding(
                "ABS001", f"{key[0]} chunk={key[1]} disagrees with "
                f"{base_key[0]} chunk=None: {specs} != {base}"))

    with _mode(devices[0]):
        oracle = _specs(case.oracle(case.make_inputs(dims, devices[0]),
                                    dims))
    if base != oracle:
        out.append(finding(
            "ABS002", f"public op spec {base} != plain-version spec "
            f"{oracle}: outputs not sliced back to the caller's shapes?"))
    return out


def run_matrix_checks(matrix=None, device="cpu") -> list:
    """ABS001/ABS002 over the op x shape matrix, on the CPU alone or, for
    a CUDA ``device``, on the CPU and the card."""
    import torch

    device = torch.device(device)
    devices = ("cpu",) if device.type == "cpu" else ("cpu", device.type)
    return [f for case in build_cases() for dims in (matrix or MATRIX)
            for f in check_case(case, dims, devices)]


def run_interface_checks(matrix=None, device="cpu") -> list:
    """ABS001/ABS002 over the op x shape matrix; on the card also
    ABS003/ABS004 over the matrix's and the paths' launches.  Returns the
    findings (empty: clean)."""
    findings = run_matrix_checks(matrix, device)
    if str(device).startswith("cuda"):
        findings.extend(run_launch_checks(matrix)[0])
    return findings


# -- launch budgets (ABS003/ABS004) ----------------------------------------

def check_launch(config: dict, attrs: dict, limits: dict) -> list:
    """ABS003/ABS004 for one launch.

    ``config``: ``kernel``, ``grid`` (x, y, z), ``threads``, ``smem``
    (dynamic bytes), and optionally ``shape``, ``source``, ``line``;
    ``attrs``: the kernel's ``max_threads``, ``static_smem``,
    ``local_bytes`` (``cudaFuncGetAttributes``); ``limits``: the device's
    ``max_grid`` (x, y, z), ``smem_optin`` and ``warp``."""
    where = f"{config['kernel']}{config.get('shape', '')}"

    def finding(rule, msg):
        return Finding(path=config.get("source", config["kernel"]),
                       line=config.get("line", 1), rule=rule,
                       severity=ERROR, message=f"{where}: {msg}")

    out = []
    threads, warp = config["threads"], limits["warp"]
    if threads < 1 or threads % warp:
        out.append(finding("ABS003", f"{threads} threads a CTA is not a "
                           f"whole number of {warp}-thread warps"))
    if threads > attrs["max_threads"]:
        out.append(finding(
            "ABS003", f"{threads} threads a CTA above the function's "
                      f"{attrs['max_threads']} (its registers and launch "
                      f"bounds): the launch would be refused"))
    for axis, n, top in zip("xyz", config["grid"], limits["max_grid"]):
        if not 1 <= n <= top:
            out.append(finding("ABS003", f"grid {axis} = {n} outside "
                               f"[1, {top}]"))
    smem = attrs["static_smem"] + config["smem"]
    if smem > limits["smem_optin"]:
        out.append(finding(
            "ABS004", f"{attrs['static_smem']} static + {config['smem']} "
                      f"dynamic bytes of shared memory above the opt-in "
                      f"{limits['smem_optin']}"))
    if attrs["local_bytes"] > 0:
        out.append(finding(
            "ABS004", f"{attrs['local_bytes']} bytes of local memory a "
                      f"thread: registers spill"))
    return out


def _ints(n: int):
    return (ctypes.c_int * n)()


def device_limits(lib) -> dict:
    """The card's launch limits (``fc_device_limits``)."""
    from repro_torch.kernels import _build

    out = _ints(5)
    _build.check(lib.fc_device_limits(ctypes.addressof(out)),
                 "fc_device_limits")
    return {"max_grid": tuple(out[:3]), "smem_optin": out[3],
            "warp": out[4]}


def geometry(lib, family: str, args) -> dict | None:
    """The launch ``fc_<family>_*`` makes for these shapes, from its
    ``fc_<family>_geometry`` twin; None when the shapes need no launch.
    Raises where the launcher refuses the shapes."""
    from repro_torch.kernels import _build

    out = _ints(6)
    entry = f"fc_{family}_geometry"
    _build.check(getattr(lib, entry)(*args, ctypes.addressof(out)),
                 f"{entry}{tuple(args)}")
    if out[0] < 0:
        return None
    return {"variant": out[0], "grid": tuple(out[1:4]), "threads": out[4],
            "smem": out[5]}


def attributes(lib, family: str, variant: int, threads: int,
               smem: int) -> dict:
    """``cudaFuncGetAttributes`` of one kernel variant, and the CTAs of
    ``threads`` threads and ``smem`` dynamic bytes an SM holds."""
    from repro_torch.kernels import _build

    out = _ints(5)
    entry = f"fc_{family}_attributes"
    _build.check(getattr(lib, entry)(variant, threads, smem,
                                     ctypes.addressof(out)), entry)
    return dict(zip(("num_regs", "local_bytes", "static_smem",
                     "max_threads", "ctas_per_sm"), out))


def _entry_line(source: str, family: str) -> int:
    """Line of ``fc_<family>_geometry`` in its source, for findings."""
    from repro_torch.analysis.walker import repo_root

    text = (repo_root() / CSRC / source).read_text()
    needle = f"fc_{family}_geometry("
    for i, line in enumerate(text.splitlines(), 1):
        if needle in line:
            return i
    return 1


def matrix_launches(matrix=None):
    """(family, geometry arguments) of every launch the matrix's calls
    make, chunked and not."""
    for d in (matrix or MATRIX):
        for chunk in CHUNKS:
            nb = d["nb"] if chunk is None else min(chunk, d["nb"])
            yield "fps", (nb, d["bs"], d["k"])
            yield "ball_query", (nb, d["k"], d["w"], d["num"])
            yield "knn", (nb, d["m"], d["w"], 3)
            for aligned in (1, 0):
                yield "gather", (nb, d["w"], d["c"], d["m"], aligned)
            yield "scatter_add", (nb, d["m"], d["c"], d["w"])
            yield "fractal_level", (nb, d["bs"])


def run_launch_checks(matrix=None, shapes=PATH_SHAPES):
    """ABS003/ABS004 for every launch of the matrix and of ``shapes``, on
    the card.  Returns (findings, rows): one row a kernel variant with its
    attributes, the threads and largest dynamic shared memory it was
    launched with, and the fewest CTAs an SM held at those launches."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fps as _fps

    lib = _build.library()
    limits = device_limits(lib)
    findings, rows = [], {}
    for family, args in (*matrix_launches(matrix), *shapes):
        if family == "fps":     # the width picks the kernel, as on a path
            family = f"fps_{_fps.variant(args[1])}"
        source, variants = LAUNCHERS[family]
        where = {"source": CSRC + source,
                 "line": _entry_line(source, family),
                 "shape": str(tuple(args))}
        try:
            geo = geometry(lib, family, args)
        except RuntimeError as e:
            findings.append(Finding(
                path=where["source"], line=where["line"], rule="ABS003",
                severity=ERROR, message=f"{family}{where['shape']}: the "
                f"launcher refuses these shapes: {e}"))
            continue
        if geo is None:
            continue
        kernel = variants[geo["variant"]]
        attrs = attributes(lib, family, geo["variant"], geo["threads"],
                           geo["smem"])
        findings.extend(check_launch(dict(where, kernel=kernel, **geo),
                                     attrs, limits))
        row = rows.setdefault(kernel, dict(
            attrs, kernel=kernel, source=source, threads=set(),
            max_smem=0, min_ctas_per_sm=attrs["ctas_per_sm"], launches=0))
        row["threads"].add(geo["threads"])
        row["max_smem"] = max(row["max_smem"], geo["smem"])
        row["min_ctas_per_sm"] = min(row["min_ctas_per_sm"],
                                     attrs["ctas_per_sm"])
        row["launches"] += 1
    return findings, rows


def all_variants() -> list:
    """Every kernel variant of the library, by name."""
    return [k for _src, ks in LAUNCHERS.values() for k in ks]
