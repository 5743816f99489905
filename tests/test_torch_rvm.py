"""havatar_tpu_torch.preprocess.rvm and the RVM matting backend against
havatar_tpu's on the CPU.

A seeded port ``MattingNetwork`` (official rvm_mobilenetv3 key layout)
gives its ``state_dict()`` to JAX's ``convert_torch_rvm``. A 64^2 forward
at full resolution (fgr, pha and all four recurrent states, atol 2e-4:
JAX's own bound), three frames carrying the state, comparing all four
states each frame (atol 5e-4, JAX's bound across frames), and the refiner
at downsample ratio 0.5 and, at 72^2, 0.25 (odd sizes in the pooled
pyramid; atol 5e-4). ``rvm_from_jax`` rebuilds the net from JAX's folded
params; ``RVMBackend`` mats three frames as ``JaxRVMBackend`` does from the
same ``.pth`` file, and ``reset`` starts the state again.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from havatar_tpu.preprocess import matting as JM
from havatar_tpu.preprocess import rvm as JR
from havatar_tpu_torch.checkpoints.convert import rvm_from_jax
from havatar_tpu_torch.preprocess import matting as M
from havatar_tpu_torch.preprocess import rvm as R


@pytest.fixture(scope="module")
def nets():
    net = R.seeded_rvm(0)
    params = JR.convert_torch_rvm(
        {k: v.numpy() for k, v in net.state_dict().items()})
    return net, params


def _port(net, src, rec=(None,) * 4, ratio=1.0):
    with torch.no_grad():
        fgr, pha, rec = net(torch.from_numpy(src).permute(0, 3, 1, 2), rec,
                            ratio)
    return fgr, pha, rec


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=atol)


def _jax_fn(ratio):
    return jax.jit(lambda p, s, rec: JR.rvm_forward(
        p, s, rec, downsample_ratio=ratio))


def test_full_resolution_forward_matches_jax(nets):
    net, params = nets
    src = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    fgr, pha, rec = _port(net, src)
    wf, wp, wrec = jax.jit(lambda p, s: JR.rvm_forward(p, s))(
        params, jnp.asarray(src))
    assert pha.shape == (1, 1, 64, 64) and float(pha.std()) > 1e-3
    _close((fgr, pha), (wf, wp), 2e-4)
    assert [r.shape[1] for r in rec] == [16, 20, 40, 64]
    _close(rec, wrec, 2e-4)


@pytest.mark.parametrize("size,ratio", [(64, 1.0), (128, 0.5), (72, 0.25)])
def test_recurrent_state_matches_jax_frame_by_frame(nets, size, ratio):
    """Three frames; every frame's fgr, pha and all four states."""
    net, params = nets
    rng = np.random.RandomState(2)
    fn = _jax_fn(ratio)
    rec, jrec = (None,) * 4, None
    for k in range(3):
        src = rng.rand(1, size, size, 3).astype(np.float32)
        fgr, pha, rec = _port(net, src, rec, ratio)
        if jrec is None:
            wf, wp, jrec = jax.jit(lambda p, s: JR.rvm_forward(
                p, s, downsample_ratio=ratio))(params, jnp.asarray(src))
        else:
            wf, wp, jrec = fn(params, jnp.asarray(src), jrec)
        _close((fgr, pha), (wf, wp), 5e-4)
        _close(rec, jrec, 5e-4)


def test_rvm_from_jax(nets):
    _, params = nets
    src = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    for ratio in (1.0, 0.5):
        got = _port(rvm_from_jax(params), src, ratio=ratio)
        want = jax.jit(lambda p, s: JR.rvm_forward(
            p, s, downsample_ratio=ratio))(params, jnp.asarray(src))
        _close(got[:2], want[:2], 2e-4)
        _close(got[2], want[2], 2e-4)


def test_rvm_backend_matches_jax_backend(nets, tmp_path):
    net, _ = nets
    path = str(tmp_path / "rvm.pth")
    torch.save(net.state_dict(), path)
    ours = M.RVMBackend(path, downsample_ratio=0.5, device="cpu")
    theirs = JM.JaxRVMBackend(path, downsample_ratio=0.5)
    rng = np.random.RandomState(4)
    frames = [(rng.rand(64, 48, 3) * 255).astype(np.uint8) for _ in range(3)]
    first = None
    for f in frames:
        a = ours.alpha(f)
        np.testing.assert_allclose(a, theirs.alpha(f), atol=5e-4)
        first = a if first is None else first
    assert all(r is not None for r in ours.rec)
    ours.reset()
    assert ours.rec == (None,) * 4
    np.testing.assert_array_equal(ours.alpha(frames[0]), first)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.RVMBackend(path)
