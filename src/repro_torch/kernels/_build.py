"""Build the CUDA kernels of ``csrc/`` into one shared library, on first use.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then linked into ``libfractal_kernels.so`` with a
plain C interface that ``ctypes`` loads -- no PyTorch headers, so a build
takes seconds.  The library lands in ``build/torch_ext/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused; what ``ptxas`` reported for each
source (registers, spills) is kept beside it and read again on reuse.

Nothing here runs at import: ``library()`` builds and loads on its first
call, which only a wrapper handed a CUDA tensor makes.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ("-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry returns a cudaError_t as int.
SIGNATURES = {
    "fc_fps_warp_blocks": [_P, _P, _P, _I, _I, _I, _P],
    "fc_fps_cta_blocks": [_P, _P, _P, _I, _I, _I, _P],
    "fc_fps_wide_blocks": [_P, _P, _P, _P, _I, _I, _I, _P],
    "fc_ball_query_blocks": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             ctypes.c_float, _P],
    "fc_knn_blocks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fc_gather_blocks": [_P, _P, _P, _I, _I, _I, _I, _P],
    "fc_scatter_add_blocks": [_P, _P, _P, _I, _I, _I, _I, _P],
    "fc_fractal_level_blocks": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # coords, valid, dim0 (or null), dim0 as an int, B, n, depth, th, ML,
    # scratch, coords out, int32 outputs' pointers, bool outputs' pointers,
    # int launched out, stream; and the scratch it needs (words out).
    "fc_partition": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    "fc_partition_scratch": [_I, _I, _I, _P],
    # g, nidx, gmask, rel, w_r, bias, out, B, m, C, ns, stream
    "fc_local_aggregate": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # out, vals, wgt, leaf_start, count, B, leaves, rows, bs, C, stream
    "fc_interp_blend": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qkv, nidx, mask, rel, the eleven weights, out, B, m, C, k, N, stream
    "fc_vector_attention": [_P] * 16 + [_I, _I, _I, _I, _I, _P],
    # Query twins of the launchers: the launch geometry of given shapes
    # (shape ints, then an int[6] out), without a launch; a kernel
    # variant's attributes (variant, threads, smem, int[5] out); and the
    # card's limits (int[5] out).
    "fc_fps_warp_geometry": [_I, _I, _I, _P],
    "fc_fps_cta_geometry": [_I, _I, _I, _P],
    "fc_fps_wide_geometry": [_I, _I, _I, _P],
    "fc_ball_query_geometry": [_I, _I, _I, _I, _P],
    "fc_knn_geometry": [_I, _I, _I, _I, _P],
    "fc_gather_geometry": [_I, _I, _I, _I, _I, _P],
    "fc_scatter_add_geometry": [_I, _I, _I, _I, _P],
    "fc_fractal_level_geometry": [_I, _I, _P],
    "fc_partition_geometry": [_I, _I, _I, _I, _P],   # B, n, depth, stage
    "fc_local_aggregate_geometry": [_I, _I, _I, _I, _I, _P],  # + aligned
    "fc_interp_blend_geometry": [_I, _I, _I, _I, _P],  # NB, bs, C, aligned
    "fc_vector_attention_geometry": [_I, _I, _I, _I, _I, _P],  # B m C k N
    **{f"fc_{family}_attributes": [_I, _I, _I, _P]
       for family in ("fps_warp", "fps_cta", "fps_wide", "ball_query", "knn",
                      "gather", "scatter_add", "fractal_level",
                      "partition", "local_aggregate", "interp_blend",
                      "vector_attention")},
    "fc_device_limits": [_P],
}

_lib = None
build_log: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def _digest(cus, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``*.cu`` of ``csrc`` in parallel and link the library
    into ``build_dir``; returns its path.  Reuses a library already built
    from identical sources."""
    cus, headers = _sources(csrc)
    out = build_dir / f"libfractal_kernels_{_digest(cus, headers)}.so"
    logs_path = out.with_suffix(".ptxas.json")
    if out.exists():
        build_log.update(path=str(out), seconds=0.0, reused=True,
                         ptxas=(json.loads(logs_path.read_text())
                                if logs_path.exists() else {}))
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(cu),
                   "-o", str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for cu, _, p in procs:
            logs[cu.name] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[f] for f in failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + link.stdout)
        logs_path.write_text(json.dumps(logs))
        os.replace(tmp_so, out)
    build_log.update(path=str(out), seconds=time.monotonic() - t0,
                     reused=False, ptxas=logs)
    return out


def load(path: Path, names=SIGNATURES) -> ctypes.CDLL:
    """Load a built library and declare the launchers in ``names``."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.fc_error_string.argtypes = [ctypes.c_int]
    lib.fc_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().fc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
