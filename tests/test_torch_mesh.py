"""The port's multi-process mesh on the CPU: ranks over gloo.

``run_ranks`` starts ``world`` processes (spawned, one intra-op thread
each), sets the environment torchrun would (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, a free ``localhost`` port) and runs one function of this
module in each with ``device="cpu"``; it returns every rank's result and
raises with a rank's traceback if one failed.  This module imports no JAX,
so the ranks start quickly; the other ``test_torch_mesh_*.py`` files hold
the comparisons with the reference and import their rank bodies from
here.

Here: the process world (a world of one without torchrun's environment,
the card asked for without one), ``shard`` / ``unshard`` and their
gradients, and the leaf blocks split over ``"model"``: FPS, ball query,
kNN and the interpolation on ``model=2`` equal ``model=1``, indices
exactly.
"""
import os
import queue as queue_lib
import socket
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import scene, serve  # noqa: E402
from repro_torch.core import bppo, fractal  # noqa: E402
from repro_torch.dist import elastic, logical, process  # noqa: E402
from repro_torch.train import pnn as train  # noqa: E402

RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        process.shutdown()


def run_ranks(fn, world: int, *args):
    """``fn(*args)`` on ``world`` gloo ranks; returns [result of rank r]."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=RANK_TIMEOUT_S)
            (results if ok else errors)[rank] = value
            if errors:
                break
    except queue_lib.Empty:
        errors[-1] = f"no result within {RANK_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise AssertionError("rank failed:\n" + "\n".join(
            f"--- rank {r}\n{e}" for r, e in sorted(errors.items())))
    assert all(not p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


# ------------------------------------------------------------ rank bodies

def world_and_mesh(model_axis):
    mesh = elastic.make_mesh(model_axis=model_axis, device="cpu")
    w = mesh.world
    return {"rank": w.rank, "size": w.size, "backend": w.backend,
            "shape": mesh.devices.shape, "ranks": mesh.ranks.tolist(),
            "groups": {k: idx for k, (_, idx) in mesh.groups.items()}}


def shard_round_trip(model_axis):
    """shard / unshard of (size, 4) tensors over "blocks" and "batch", with
    the gradient of sum((unshard(f(shard(x))))^2) for f = 3 * x."""
    mesh = elastic.make_mesh(model_axis=model_axis, device="cpu")
    out = {}
    for name, size in (("blocks", 8), ("batch", 8), ("blocks", 6)):
        x = torch.arange(size * 4, dtype=torch.float32).reshape(size, 4)
        x.requires_grad_(True)
        with logical.logical_rules(mesh, logical.RULES_V0):
            part = logical.shard(x, 0, name)
            y = logical.unshard(part * 3.0, 0, name, size)
            where = logical.placement(name, size)
        (y ** 2).sum().backward()
        out[(name, size)] = {"part": part.detach().numpy(),
                             "y": y.detach().numpy(),
                             "grad": x.grad.numpy(),
                             "ways": None if where is None else where[1]}
    return out


def cloud_batch(b, n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.5, 2.5, (b, 3, 3))
    pick = rng.integers(0, 3, (b, n))
    pts = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.normal(0, 0.3, (b, n, 3))
    return pts.astype(np.float32)


def leaf_ops(model_axis, chunk):
    """FPS, ball query, kNN and the interpolation on the leaf blocks of
    two 300-point clouds, under the mesh's rules."""
    mesh = elastic.make_mesh(model_axis=model_axis, device="cpu")
    pts = torch.from_numpy(cloud_batch(2, 300, 5))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    valid[1, 250:] = False
    feats = torch.from_numpy(
        np.random.default_rng(6).normal(size=(2, 80, 5)).astype(np.float32))
    feats.requires_grad_(True)
    with logical.logical_rules(mesh, logical.RULES_V0):
        part = fractal.partition(pts, valid, th=32)
        samp = bppo.blockwise_fps(part, rate=0.25, k_out=80, bs=32)
        nb = bppo.blockwise_ball_query(part, samp, radius=0.6, num=8, w=64,
                                       chunk=chunk)
        kn = bppo.blockwise_knn(part, samp, k=4, w=64, chunk=chunk)
        out = bppo.blockwise_interpolate(part, samp, feats, wc=48, bs=32,
                                         chunk=chunk)
        idx3, w3 = bppo.blockwise_interpolation_weights(part, samp, wc=48,
                                                        bs=32, chunk=chunk)
    (out ** 2).sum().backward()
    arr = lambda t: t.detach().numpy()  # noqa: E731
    return {"samp_idx": arr(samp.idx), "local": arr(samp.local_idx),
            "bq_idx": arr(nb.idx), "bq_cnt": arr(nb.cnt), "bq_d2": arr(nb.d2),
            "knn_idx": arr(kn.idx), "knn_d2": arr(kn.d2), "out": arr(out),
            "idx3": arr(idx3), "w3": arr(w3), "grad": arr(feats.grad),
            "blocks": part.batch * part.ml}


class RankClock:
    """Rank 0's clock passes every deadline at once; the other ranks'
    never moves, so they dispatch only what rank 0 decides."""

    def __init__(self, rank):
        self.rank, self.t = rank, 0.0

    def __call__(self):
        if self.rank == 0:
            self.t += 10.0
        return self.t


def serve_stream(kw, params, clouds, model_axis, mesh):
    """Serve ``clouds`` in order (submit, step, flush at the end) through a
    ``ServeEngine(ServeConfig(**kw))`` on the CPU; with ``mesh`` over the
    world's (data, model) mesh.  Returns (logits in request order,
    stats)."""
    cfg = serve.ServeConfig(mesh="auto" if mesh else "none",
                            model_axis=model_axis, **kw)
    rank = int(os.environ.get("RANK", 0))
    eng = serve.ServeEngine(cfg, params=params, device="cpu",
                            clock=RankClock(rank))
    rids = []
    for c in clouds:
        rids.append(eng.submit(c))
        eng.step()
    eng.flush()
    return [eng.take(r) for r in rids], eng.stats()


def segment_scene(cfg_kw, params, coords, model_axis):
    """Segment ``coords`` through a ``SceneEngine`` on the CPU; on the
    world's mesh where ``model_axis`` is given."""
    mesh = "none" if model_axis is None else "auto"
    eng = scene.SceneEngine(scene.SceneConfig(mesh=mesh,
                                              model_axis=model_axis or 2,
                                              **cfg_kw),
                            params=params, device="cpu")
    logits, plan = eng.infer(coords)
    return logits


def fit_ranks(cfg_kw, model_axis, fail_at=None):
    """``train.pnn.fit`` on the world's mesh (CPU); returns the losses and
    the trained parameters, flat.  ``fail_at`` stops the loop there."""
    cfg = train.TrainConfig(mesh="auto", model_axis=model_axis,
                            device="cpu", **cfg_kw)
    if fail_at is not None:
        run = train.loop_lib.run
        train.loop_lib.run = lambda *a, **k: run(*a, fail_at=fail_at, **k)
        try:
            train.fit(cfg, log=lambda *_: None)
        except RuntimeError as e:
            assert "injected failure" in str(e)
        finally:
            train.loop_lib.run = run
        return None
    model, _, info = train.fit(cfg, log=lambda *_: None)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return {"losses": [h["loss"] for h in info["history"]],
            "params": flat.numpy()}


def pnn_cell_row(kind):
    """A tiny PNN cell (4 clouds of 512 points) on the host mesh."""
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import pnn_cell
    mesh = launch_mesh.make_host_mesh(2, device="cpu")
    shape = pnn_cell.PNNShape("tiny", 512, 4, 64)
    row = pnn_cell.run_pnn_cell("pointnet2", shape, kind=kind, batch=4,
                                mesh=mesh, verbose=False, reps=1,
                                leaf_chunk=None)
    return {k: row[k] for k in ("mesh", "chips", "batch", "local_batch",
                                "kernel_calls")}


# ------------------------------------------------------------------ tests

def test_no_torchrun_environment_is_a_world_of_one(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    world = process.init("cpu")
    assert (world.rank, world.size, world.backend) == (0, 1, None)
    mesh = elastic.make_mesh(device="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.groups == {}
    assert mesh.device == torch.device("cpu")
    x = torch.ones(4, 3)
    with logical.logical_rules(mesh, logical.RULES_V0):
        assert logical.shard(x, 0, "batch") is x
        assert logical.unshard(x, 0, "batch", 4) is x
        assert logical.lc(x, "batch", None) is x


def test_the_card_is_asked_for_without_a_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process.init(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic.make_mesh()


def test_world_ranks_groups_and_shard_round_trip():
    got = run_ranks(world_and_mesh, 4, 2)
    for r, g in enumerate(got):
        assert (g["rank"], g["size"], g["backend"]) == (r, 4, "gloo")
        assert g["shape"] == (2, 2) and g["ranks"] == [[0, 1], [2, 3]]
        d, m = divmod(r, 2)
        assert g["groups"] == {("data",): d, ("model",): m,
                               ("data", "model"): r}
    rows = run_ranks(shard_round_trip, 4, 2)
    for r, row in enumerate(rows):
        d, m = divmod(r, 2)
        for (name, size), v in row.items():
            x = np.arange(size * 4, dtype=np.float32).reshape(size, 4)
            # "blocks" -> model (2 ways), "batch" -> data (2 ways); 6 rows
            # divide 2, so every dim here splits.
            i = m if name == "blocks" else d
            n = size // 2
            assert v["ways"] == 2
            np.testing.assert_array_equal(v["part"], x[i * n:(i + 1) * n])
            np.testing.assert_array_equal(v["y"], 3 * x)
            # d/dx sum((3x)^2) = 18x on every row, on every rank: the
            # unshard's backward takes this rank's slice, the shard's
            # backward all-gathers the slices.
            np.testing.assert_array_equal(v["grad"], 18 * x)


@pytest.mark.parametrize("chunk", [None, 5])
def test_leaf_blocks_split_over_model_equal_one_rank(chunk):
    want = leaf_ops(1, chunk)
    got = run_ranks(leaf_ops, 2, 2, chunk)
    for row in got:
        assert row["blocks"] % 2 == 0   # the split happened
        for k, v in want.items():
            np.testing.assert_array_equal(row[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_pnn_cell_on_the_host_mesh(kind):
    """The batch over "data" of the (2, 2) host mesh: each rank steps on
    two of the four clouds, and the row names the mesh and its chips."""
    for row in run_ranks(pnn_cell_row, 4, kind):
        assert (row["mesh"], row["chips"]) == ("2x2", 4)
        assert (row["batch"], row["local_batch"]) == (4, 2)
        assert set(row["kernel_calls"]) >= {"fps_blocks", "gather_blocks"}
