"""Multi-process helpers of the tests of ``havatar_tpu_torch.parallel``:
``run_ranks`` spawns a ``gloo`` process group on the CPU and runs one of the
worker functions below in every rank.

The workers run in spawned processes, so this module imports neither JAX
nor ``havatar_tpu``: a test computes the JAX side in its own process and
passes numpy arrays and state dicts in. Every rank builds the same modules
from the same weights and reads the same global batch, then takes its
block; rank 0 also computes the one-process result on its own, so that
both sides run with the same threads.
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, List

import numpy as np
import torch
import torch.multiprocessing as mp

THREADS = 2


def _entry(rank: int, world: int, init_file: str, out_dir: str,
           fn: Callable, args: tuple, timeout_s: float) -> None:
    from havatar_tpu_torch.parallel import comm
    torch.set_num_threads(THREADS)
    comm.initialize("cpu", init_method=f"file://{init_file}", rank=rank,
                    world_size=world,
                    timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        comm.shutdown()


def run_ranks(fn: Callable, world: int, tmp_dir: str, *args,
              timeout_s: float = 600.0) -> List[Any]:
    """``fn(rank, world, *args)`` in each of ``world`` spawned processes
    joined in a gloo group (rendezvous through a file in ``tmp_dir``);
    returns every rank's result. A rank that raises, or a run longer than
    ``timeout_s``, fails the caller: the processes are stopped."""
    os.makedirs(tmp_dir, exist_ok=True)
    init_file = os.path.join(tmp_dir, "rendezvous")
    ctx = mp.start_processes(
        _entry, args=(world, init_file, tmp_dir, fn, args, timeout_s),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def torchrun(module: str, args: list, nproc: int = 2,
             timeout_s: float = 600.0) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m module args`` from the repository's root (a free rendezvous
    port; two threads a rank); the whole process group is killed when it
    outlasts ``timeout_s``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", module, *args]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


# ---------------------------------------------------------------------------
# comm and mesh
# ---------------------------------------------------------------------------

def comm_worker(rank: int, world: int, shapes: dict) -> dict:
    """The collectives and the mesh rules on this rank; returns what the
    test checks."""
    from havatar_tpu_torch.parallel import comm, mesh as M
    out = {}
    m = M.make_mesh(("data",), "cpu")
    # tiled all-gather on axis 1 and its backward: upstream gradient
    # (rank + 1) * ones, so the reduce-scatter sum is sum(r + 1) everywhere
    x = torch.arange(6.0).reshape(2, 3).add(10 * rank).requires_grad_()
    y = comm.all_gather(x, 1, m.get_group())
    (y * (rank + 1)).sum().backward()
    out["gathered"], out["x_grad"] = y.detach(), x.grad
    out["loss_dict"] = comm.reduce_loss_dict(
        {"a": torch.tensor(float(rank)), "b": torch.tensor(2.0 * rank + 1)})
    out["sum"] = comm.reduce_sum(torch.tensor([rank + 1.0]))
    out["allgather"] = comm.process_allgather(torch.tensor([rank, 7]))
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    unused = torch.nn.Parameter(torch.zeros(1))
    p.grad = torch.full((3,), float(rank))
    q.grad = torch.full((2,), rank + 0.5, dtype=torch.float64)
    comm.all_reduce_grads([p, q, unused])
    out["avg"] = (p.grad, q.grad, unused.grad)
    p.grad = torch.full((3,), float(rank))
    comm.all_reduce_grads([p], op=torch.distributed.ReduceOp.SUM)
    out["sum_grad"] = p.grad
    b = torch.full((4,), float(rank))
    comm.broadcast_([b])
    out["broadcast"] = b
    g = torch.Generator().manual_seed(3)
    out["fold_in"] = torch.rand(3, generator=comm.fold_in(g))
    out["after_fold"] = torch.rand(3, generator=g)
    specs = M.auto_batch_shardings(m, {k: np.zeros(s) for k, s in
                                       shapes.items()})
    out["specs"] = {k: s.axis for k, s in specs.items()}
    host = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    out["ray_block"] = M.local_shard(host, M.ray_sharding(m))
    out["batch_block"] = M.shard_batch({"a": np.arange(world * 2)}, m)
    out["rank_size"] = M.mesh_rank_size(m)
    from havatar_tpu_torch.cli.common import to_device_batch
    from havatar_tpu_torch.data import device_prefetch
    batch = {"mv_rays": np.arange(world * 4 * 2.0).reshape(world, 4, 2),
             "inv_head_T": np.zeros((world, 4, 3)), "fidx": [7] * world}
    out["device_batch"] = to_device_batch(batch, "cpu", m)
    rays = {"mv_rays": np.arange(3 * 4 * world * 1.0).reshape(3, 4 * world,
                                                              1)}
    specs = M.auto_batch_shardings(m, rays)
    out["prefetched"] = next(device_prefetch(iter([rays]), device="cpu",
                                             sharding=specs))
    try:
        M.local_shard(np.zeros((world + 1, 2)), M.batch_sharding(m))
        out["uneven"] = "accepted"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serving_worker(rank: int, world: int, cfg_dict: dict, ckpt: str,
                   inputs: dict, flagship_kw: dict) -> dict:
    """The ray-sharded frame of one item and the frame-parallel frames of
    two (exact float32, the checkpoint's weights), and the tiny fused
    flagship's ray-sharded frame; rank 0 adds the one-process frames."""
    from havatar_tpu_torch.cli.reenact import load_inference_weights
    from havatar_tpu_torch.infer import reenact as RI
    from havatar_tpu_torch.infer import serving as S
    from havatar_tpu_torch.models.generators import StyleUNetSR
    from havatar_tpu_torch.models.skinning import fix_canonical_volume
    from havatar_tpu_torch.parallel import make_mesh
    from havatar_tpu_torch.train.stage1 import build_renderer
    from havatar_tpu_torch.utils.cfgnode import CfgNode

    cfg = CfgNode(cfg_dict)
    variables, _, g_ema, _ = load_inference_weights(ckpt)
    renderer = build_renderer(cfg)
    renderer.load_state_dict(variables)
    sr, gan = cfg.models.StyleUnet, cfg.gan
    gen = StyleUNetSR(inp_size=sr.inp_size, inp_ch=sr.inp_ch, out_ch=3,
                      out_size=sr.out_size, style_dim=gan.latent,
                      n_mlp=gan.n_mlp,
                      channel_multiplier=gan.channel_multiplier)
    gen.load_state_dict(g_ema)
    renderer.eval(), gen.eval()
    with torch.inference_mode():
        vol = fix_canonical_volume(renderer.skin_volume())
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    kw = dict(num_coarse=int(cfg.nerf.validation.num_coarse),
              num_fine=int(cfg.nerf.validation.num_fine), to_uint8=False)
    mesh = make_mesh(("data",), "cpu")

    def args(b):
        return dict(fixed_volume=vol, style=t["style"], rays=t["rays"][b],
                    bg=t["bg"][b], latent=t["latent"][b],
                    inv_head_T=t["inv_head_T"][b], front=t["front"][b],
                    left=t["left"][b], right=t["right"][b])

    out = {}
    one = args(slice(0, 1))
    one["rays"], one["bg"] = S.place_frame_inputs(mesh, one["rays"],
                                                  one["bg"])
    out["ray_sharded"] = S.make_sharded_frame_fn(mesh, renderer, gen,
                                                 **kw)(**one)
    two = args(slice(0, 2))
    names = ("rays", "bg", "latent", "inv_head_T", "front", "left", "right")
    placed = S.place_batch_inputs(mesh, [two[k] for k in names], [])
    two.update(zip(names, placed))
    out["frame_parallel"] = S.make_frame_parallel_fn(mesh, renderer, gen,
                                                     **kw)(**two)
    fs = RI.build_flagship("cpu", mesh=mesh, **flagship_kw)
    out["flagship_sharded"] = fs.frame_fn(**fs.inputs)
    out["flagship_rays"] = fs.inputs["rays"].shape
    if rank == 0:
        single = RI.make_reenact_fn(renderer, gen, **kw)
        out["single"] = torch.cat([single(**args(slice(b, b + 1)))
                                   for b in range(2)])
        fs1 = RI.build_flagship("cpu", **flagship_kw)
        out["flagship_single"] = fs1.frame_fn(**fs1.inputs)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def stage1_state(cfg, latent: np.ndarray):
    """The stage-1 state every process builds alike: torch's default
    initialization from seed 0, the given latent codes."""
    from havatar_tpu_torch.train import stage1 as S1
    torch.manual_seed(0)
    state = S1.init_state(cfg, latent.shape[0], "cpu")
    with torch.no_grad():
        state.latent_codes.copy_(torch.from_numpy(latent))
    return state


def grad_errors(got: dict, want: dict) -> dict:
    """name -> (max abs difference, largest |want| entry) of two
    {name: gradient or None} maps over the same names; None where the
    gradient is None on both sides."""
    assert set(got) == set(want)
    out = {}
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        out[k] = None if w is None else (float((g - w).abs().max()),
                                         float(w.abs().max()))
    return out


def checksum(grads: dict) -> tuple:
    """Sums of the gradients and of their magnitudes, in float64: ranks
    whose all-reduced gradients are equal give equal sums."""
    ts = [g.double() for g in grads.values() if g is not None]
    return (float(sum(t.sum() for t in ts)),
            float(sum(t.abs().sum() for t in ts)))


def stage1_worker(rank: int, world: int, cases: dict,
                  latent: np.ndarray) -> dict:
    """Each case's loss and metrics on this rank's block and the checksum
    of its raw gradients averaged over the ranks (equal on every rank);
    the rank ``i % world`` of the i-th case also runs the one-process loss
    on the whole batch and returns its loss, metrics and the per-tensor
    difference of the gradients. A case: (cfg dict, global batch, global
    draws or None, frame_parallel, lpips params or None); the renderer is
    built once per ``models`` section."""
    from havatar_tpu_torch.parallel import comm, make_mesh
    from havatar_tpu_torch.parallel import mesh as M
    from havatar_tpu_torch.train import stage1 as S1
    from havatar_tpu_torch.utils.cfgnode import CfgNode
    mesh = make_mesh(("data",), "cpu")
    states, out = {}, {}

    def run(cfg, state, batch, noise, mesh, frames, lpips):
        params = dict(state.renderer.named_parameters(),
                      latent_codes=state.latent_codes)
        for p in params.values():
            p.grad = None
        loss, metrics = S1.make_loss_fn(state.renderer, cfg, lpips, mesh,
                                        frames)(state.latent_codes, batch,
                                                noise)
        loss.backward()
        if mesh is not None:
            comm.all_reduce_grads(params.values())
        return (float(loss), {k: float(v) for k, v in metrics.items()},
                {k: None if p.grad is None else p.grad.clone()
                 for k, p in params.items()})

    for i, (name, (cfg_dict, batch, noise, frames, lpips)) in enumerate(
            cases.items()):
        cfg = CfgNode(cfg_dict)
        key = repr(cfg_dict["models"])
        if key not in states:
            states[key] = stage1_state(cfg, latent)
        state = states[key]
        # the rays split even where the frames would divide the world size
        spec = (M.batch_sharding if frames else M.ray_sharding)(mesh)
        local = {k: torch.from_numpy(np.ascontiguousarray(M.local_shard(
            v, spec if frames or k in M.RAY_AXIS_KEYS else None)))
            for k, v in batch.items()}
        loss, metrics, grads = run(cfg, state, local, noise, mesh, frames,
                                   lpips)
        res = {"loss": loss, "metrics": metrics, "checksum": checksum(grads)}
        if i % world == rank:
            whole = {k: torch.from_numpy(v) for k, v in batch.items()}
            loss1, metrics1, grads1 = run(cfg, state, whole, noise, None,
                                          False, lpips)
            res.update(single=(loss1, metrics1),
                       errors=grad_errors(grads, grads1))
        out[name] = res
    return out


def stage2_worker(rank: int, world: int, cfg_dict: dict,
                  split: str) -> dict:
    """Raw D, R1, G and NeRF gradients of one d_step, r1_step and g_step
    (learning rates 0, so every step sees the same weights) on the first
    batch of the tiny set, its rays split over the ranks, with seeded draws
    of the whole batch; rank 0 also the one-process ones."""
    from havatar_tpu_torch.cli.common import BATCH_KEYS
    from havatar_tpu_torch.cli.train_avatarHD import prepare_batch
    from havatar_tpu_torch.data import AvatarDataset, Loader
    from havatar_tpu_torch.models.renderer import draw_render_noise
    from havatar_tpu_torch.parallel import make_mesh
    from havatar_tpu_torch.parallel import mesh as M
    from havatar_tpu_torch.train import stage2 as S2
    from havatar_tpu_torch.utils.cfgnode import CfgNode

    cfg = CfgNode(cfg_dict)
    su = cfg.models.StyleUnet
    ds = AvatarDataset(split, "train", cfg,
                       down_sample=cfg.dataset.down_sample, full_image=True)
    host = prepare_batch(next(iter(Loader(ds, batch_size=cfg.gan.batch,
                                          shuffle=False, num_workers=1))),
                         su.out_size, su.inp_size)
    host = {k: v for k, v in host.items() if k in BATCH_KEYS}
    mesh = make_mesh(("data",), "cpu")

    def run(batch, mesh):
        torch.manual_seed(0)
        state = S2.init_state(cfg, len(ds), "cpu")
        for opt in (state.nerf_opt, state.g_opt, state.d_opt):
            for pg in opt.param_groups:
                pg["lr"] = 0.0
        d_step, r1_step, g_step, _ = S2.make_steps(state, cfg, None, mesh)
        B, R = host["mv_rays"].shape[:2]
        g = torch.Generator().manual_seed(5)
        nerf = cfg.nerf.train
        dr = S2.Stage2Draws(
            draw_render_noise(g, B, R, nerf.num_coarse, nerf.num_fine, True,
                              float(nerf.radiance_field_noise_std), "cpu"),
            S2.sample_styles(g, state.generator, B, cfg.gan, "cpu"))

        def grads(module):
            return {k: p.grad.clone() for k, p in module.named_parameters()
                    if p.grad is not None}

        res = {"d_metrics": {k: float(v) for k, v in
                             d_step(batch, dr).items()}}
        res["d"] = grads(state.discriminator)
        res["r1_metrics"] = {k: float(v) for k, v in r1_step(batch).items()}
        res["r1"] = grads(state.discriminator)
        res["g_metrics"] = {k: float(v) for k, v in
                            g_step(batch, dr).items()}
        res["g"] = grads(state.generator)
        res["nerf"] = grads(state.renderer)
        res["nerf"]["latent_codes"] = state.latent_codes.grad.clone()
        return res

    spec = M.ray_sharding(mesh)
    local = {k: torch.from_numpy(np.ascontiguousarray(M.local_shard(
        v, spec if k in M.RAY_AXIS_KEYS else None))) for k, v in host.items()}
    got = run(local, mesh)
    out = {"rays": tuple(local["mv_rays"].shape),
           "metrics": {k: got[k] for k in got if k.endswith("metrics")},
           "checksum": {k: checksum(got[k]) for k in STAGE2_GRADS}}
    if rank == 0:
        want = run({k: torch.from_numpy(v) for k, v in host.items()}, None)
        out["single"] = {k: want[k] for k in want if k.endswith("metrics")}
        out["errors"] = {k: grad_errors(got[k], want[k])
                         for k in STAGE2_GRADS}
    return out


STAGE2_GRADS = ("d", "r1", "g", "nerf")
