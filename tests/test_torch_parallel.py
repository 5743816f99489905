"""``havatar_tpu_torch.parallel`` (the process group, its collectives and
the mesh rules) on ``gloo`` process groups of 2 and 4 CPU ranks, and the
batch rule against havatar_tpu's ``parallel.mesh.auto_batch_shardings`` on
the same shapes (a 2- and a 4-device slice of this process's virtual CPU
mesh).

Each world size is one spawn (``tests/torch_dist.py:comm_worker``), whose
ranks run every check and return what the tests below hold.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from havatar_tpu.parallel import mesh as JM
from havatar_tpu_torch.device import resolve_device
from havatar_tpu_torch.parallel import comm
from havatar_tpu_torch.parallel import mesh as TM

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist  # noqa: E402

WORLDS = (2, 4)
# one example covers the rule's three cases at both world sizes: the frame
# axis divides (4 frames), only the ray axis of a ray key does (3 frames of
# 16 rays), neither does (3 frames of 6 rays at world 4, an image key, a
# scalar)
SHAPES = {"mv_rays": (3, 16, 11), "gt_color": (3, 6, 3),
          "front_render_cond": (4, 8, 8, 7), "dataset_idx": (4,),
          "inv_head_T": (3, 4, 3), "step": ()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = torch_dist.run_ranks(
                torch_dist.comm_worker, world,
                str(tmp_path_factory.mktemp(f"comm{world}")), SHAPES)
        return cache[world]
    return get


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_is_tiled_and_its_backward_a_reduce_scatter(ranks, world):
    """Rank r holds [[0, 1, 2], [3, 4, 5]] + 10 r; the all-gather on axis 1
    concatenates the blocks in rank order on every rank. The loss on rank
    r scales the gathered tensor by r + 1, so each rank's block gets the
    sum over the ranks of r + 1 as its gradient."""
    base = torch.arange(6.0).reshape(2, 3)
    want = torch.cat([base + 10 * r for r in range(world)], 1)
    for out in ranks(world):
        assert torch.equal(out["gathered"], want)
        assert torch.equal(out["x_grad"], torch.full(
            (2, 3), float(sum(r + 1 for r in range(world)))))


@pytest.mark.parametrize("world", WORLDS)
def test_reductions_broadcast_and_fold_in(ranks, world):
    """reduce_loss_dict averages every entry; reduce_sum sums;
    process_allgather stacks the ranks' tensors; all_reduce_grads averages
    (or sums) the gradients of parameters that have one, a flat buffer a
    dtype, and leaves a parameter without one alone; broadcast_ takes rank
    0's values; fold_in gives each rank a generator of its own and moves
    the shared one by the same draw on every rank."""
    outs = ranks(world)
    mean = (world - 1) / 2
    for r, out in enumerate(outs):
        assert float(out["loss_dict"]["a"]) == pytest.approx(mean)
        assert float(out["loss_dict"]["b"]) == pytest.approx(2 * mean + 1)
        assert float(out["sum"]) == world * (world + 1) / 2
        assert torch.equal(out["allgather"], torch.tensor(
            [[i, 7] for i in range(world)]))
        p, q, unused = out["avg"]
        assert torch.allclose(p, torch.full((3,), mean))
        assert q.dtype == torch.float64
        assert torch.allclose(q, torch.full((2,), mean + 0.5,
                                            dtype=torch.float64))
        assert unused is None
        assert torch.equal(out["sum_grad"], torch.full(
            (3,), float(sum(range(world)))))
        assert torch.equal(out["broadcast"], torch.zeros(4))
        assert out["rank_size"] == (r, world)
    folds = [out["fold_in"] for out in outs]
    assert all(not torch.equal(a, b) for i, a in enumerate(folds)
               for b in folds[i + 1:])
    assert all(torch.equal(out["after_fold"], outs[0]["after_fold"])
               for out in outs)


@pytest.mark.parametrize("world", WORLDS)
def test_auto_batch_shardings_match_jax(ranks, world):
    """The port's per-key split axis equals JAX's PartitionSpec on a
    ``world``-device mesh, key by key, over the rule's three cases."""
    mesh = JM.make_mesh(("data",), devices=jax.devices()[:world])
    jax_specs = JM.auto_batch_shardings(
        mesh, {k: np.zeros(s) for k, s in SHAPES.items()})

    def axis(sharding):
        spec = tuple(sharding.spec)
        return spec.index("data") if "data" in spec else None

    want = {k: axis(s) for k, s in jax_specs.items()}
    assert set(want.values()) == {0, 1, None}
    for out in ranks(world):
        assert out["specs"] == want


@pytest.mark.parametrize("world", WORLDS)
def test_local_shard_and_shard_batch(ranks, world):
    """local_shard takes rank r's block of the ray axis, shard_batch of the
    leading axis of every array of a dict, and an axis that does not split
    evenly is refused."""
    host = np.arange(2 * 4 * 3).reshape(2, 4, 3)
    k = 4 // world
    for r, out in enumerate(ranks(world)):
        np.testing.assert_array_equal(out["ray_block"],
                                      host[:, r * k:(r + 1) * k])
        np.testing.assert_array_equal(out["batch_block"]["a"],
                                      np.arange(2 * r, 2 * r + 2))
        assert "does not split" in out["uneven"]


@pytest.mark.parametrize("world", WORLDS)
def test_device_batch_and_prefetch_stage_this_ranks_block(ranks, world):
    """to_device_batch(mesh=...) keeps rank r's frames of the model inputs
    (the world size divides them) and passes the other entries through;
    device_prefetch(sharding=...) stages rank r's rays of 3 frames (the
    world size divides the rays only)."""
    for r, out in enumerate(ranks(world)):
        b = out["device_batch"]
        assert torch.equal(b["mv_rays"], torch.arange(
            8.0 * r, 8.0 * r + 8).reshape(1, 4, 2))
        assert tuple(b["inv_head_T"].shape) == (1, 4, 3)
        assert b["fidx"] == [7] * world
        rays = np.arange(3 * 4 * world * 1.0).reshape(3, 4 * world, 1)
        assert torch.equal(out["prefetched"]["mv_rays"], torch.from_numpy(
            rays[:, 4 * r:4 * r + 4]))


def test_one_rank_without_a_process_group(monkeypatch):
    """Without torchrun's environment initialize is a no-op and every
    collective the identity of one rank; a WORLD_SIZE above 1 with no
    process group raises instead of running one rank's block as the whole;
    pad_to_multiple is JAX's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert comm.initialize("cpu") is False
    assert (comm.get_rank(), comm.get_world_size(), comm.is_primary()) == (
        0, 1, True)
    x = torch.arange(4.0)
    assert comm.all_gather(x, 0) is x
    assert torch.equal(comm.process_allgather(x), x[None])
    v = x[1]
    assert comm.reduce_loss_dict({"a": v})["a"] is v
    with comm.process_group("cpu"):
        assert comm.get_world_size() == 1
    with pytest.raises(RuntimeError, match="make_mesh needs a process"):
        TM.make_mesh(("data",), "cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="joined no process group"):
        comm.all_gather(x, 0)
    for size, mult in ((5, 4), (8, 4)):
        a = np.arange(size * 2.0).reshape(size, 2)
        got, n = TM.pad_to_multiple(a, mult, 0)
        want, m = JM.pad_to_multiple(a, mult, 0)
        assert n == m and np.array_equal(got, want)
