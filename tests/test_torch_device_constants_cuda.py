"""No synchronising call inside a training step's forward and backward on
the card: the renderer (quad op and dense chain), ``StyleUNetSR``, the
discriminator, ``lpips_loss``, compositing's cumulative product (whose
gradient is ``torch.cumprod``'s to the bit) and one whole stage-1 step, each
run once to warm up (kernel builds, the ops' device constants) and then
again under ``torch.cuda.set_sync_debug_mode("error")``, where any copy from
the host, host read or stream synchronise raises. The second run makes no
new device constant (``utils/profiling.py:constant_uploads``).

Sizes are tiny (the stage-2 step tests' renders of 16^2 rays and 64^2
images), at the widths the CUDA kernels take (64-channel planes, 8 posenc
frequencies). This file imports no JAX:

    python -m pytest --noconftest \
        tests/test_torch_device_constants_cuda.py -m cuda -q

Without a CUDA device every test here skips.
"""

import pytest
import torch

from havatar_tpu_torch.models.discriminator import WaveletDiscriminator
from havatar_tpu_torch.models.generators import StyleUNetSR
from havatar_tpu_torch.ops.volume_render import cumprod_exclusive
from havatar_tpu_torch.train import stage1
from havatar_tpu_torch.train.lpips import init_lpips_params, lpips_loss
from havatar_tpu_torch.utils.cfgnode import CfgNode
from havatar_tpu_torch.utils.profiling import constant_uploads

B, RENDER, GEN, COND = 2, 16, 64, 32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg(**models) -> CfgNode:
    """The stage-2 step tests' tiny configuration at the kernels' widths."""
    return CfgNode({
        "experiment": {"randomseed": 0, "latent_code_dim": 8,
                       "mask_weight": 0.01, "rgb_loss": "mse",
                       "patch_rgb": True, "cond_pose": True,
                       "cond_expr": False},
        "dataset": {"cond_render_res": COND},
        "models": {"StyleUnet": {"inp_size": RENDER, "inp_ch": 64,
                                 "out_ch": 64, "out_size": GEN},
                   "coarse": {"XYZ_bounding": [[-1.5, 1.5], [-1.6, 1.4],
                                               [-1.6, 1.2]],
                              "num_encoding_fn_xyz": 8,
                              "plane_feat_dim": 64, "plane_res": 16,
                              "plane_middle_size": 4, "skin_vol_res": 8},
                   **models},
        "optimizer": {"type": "adam", "lr": 5e-4},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1,
                      "lr_floor": 5e-5},
        "nerf": {"train": {"perturb": True, "num_coarse": 8, "num_fine": 4,
                           "radiance_field_noise_std": 0.1}},
    })


def _batch(dev, R: int = RENDER * RENDER):
    g = torch.Generator(device=dev).manual_seed(0)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    d = torch.randn(B, R, 3, generator=g, device=dev) * 0.05
    d[..., 2] -= 1.0
    rays = torch.cat([u(B, R, 3) * 0.2 - 0.1 + torch.tensor(
        [0.0, 0.0, 3.0], device=dev), d / d.norm(dim=-1, keepdim=True),
        torch.full((B, R, 1), 1.4, device=dev),
        torch.full((B, R, 1), 4.0, device=dev), u(B, R, 3),
        (u(B, R, 1) > 0.5).float()], -1)
    return {"mv_rays": rays, "gt_color": u(B, R, 3),
            "dataset_idx": torch.arange(B, device=dev),
            "inv_head_T": torch.cat([torch.eye(3, device=dev),
                                     torch.zeros(1, 3, device=dev)]
                                    ).expand(B, 4, 3).contiguous(),
            "front_render_cond": u(B, COND, COND, 7),
            "left_render_cond": u(B, COND, COND, 7),
            "right_render_cond": u(B, COND, COND, 7)}


def _lpips_params(dev, seed: int):
    params = init_lpips_params(torch.Generator().manual_seed(seed))
    return {"conv": {k: {n: t.to(dev) for n, t in v.items()}
                     for k, v in params["conv"].items()},
            "lin": {k: t.to(dev) for k, t in params["lin"].items()}}


def _without_syncs(fn) -> None:
    """fn() once, then again with every synchronising call raising; the
    second makes no device constant."""
    fn()
    torch.cuda.synchronize()
    made = constant_uploads()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert constant_uploads() == made


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["use_pallas_mlp_quad", "use_pallas_mlp"])
def test_renderer_forward_backward(dev, route):
    cfg = _cfg(**{route: True})
    with torch.device(dev):
        renderer = stage1.build_renderer(cfg).train()
    assert (renderer.model_coarse.use_fused_quad
            == (route == "use_pallas_mlp_quad"))
    batch = _batch(dev)
    rays = batch["mv_rays"]
    latent = torch.zeros(B, 8, device=dev, requires_grad=True)
    g = torch.Generator(device=dev).manual_seed(1)

    def step():
        out = renderer(rays[..., :8], rays[..., 8:11], latent,
                       batch["inv_head_T"], batch["front_render_cond"],
                       batch["left_render_cond"], batch["right_render_cond"],
                       num_coarse=8, num_fine=4, perturb=True,
                       radiance_field_noise_std=0.1, rng=g)
        (out["rgb_fine"].square().mean()
         + out["acc_coarse"].mean()).backward()

    _without_syncs(step)


@pytest.mark.cuda
def test_sr_forward_backward(dev):
    with torch.device(dev):
        gen = StyleUNetSR(inp_size=RENDER, inp_ch=16, out_ch=3,
                          out_size=GEN, style_dim=16, n_mlp=2,
                          channel_multiplier=1).train()
    g = torch.Generator(device=dev).manual_seed(2)
    z = torch.randn(2, B, 16, generator=g, device=dev)
    cond = torch.rand(B, 16, RENDER, RENDER, generator=g, device=dev,
                      requires_grad=True)
    noise = gen.draw_noise(B, g, dev)

    def step():
        gen([z[0], z[1]], cond, noise=noise, inject_index=3
            ).square().mean().backward()

    _without_syncs(step)


@pytest.mark.cuda
def test_discriminator_forward_backward(dev):
    with torch.device(dev):
        disc = WaveletDiscriminator(size=GEN, img_channel=3,
                                    channel_multiplier=1).train()
    img = torch.rand(B, 3, GEN, GEN, device=dev, requires_grad=True)

    def step():
        disc(img).sum().backward()

    _without_syncs(step)


@pytest.mark.cuda
def test_lpips_forward_backward(dev):
    params = _lpips_params(dev, 3)
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.rand(B, GEN, GEN, 3, generator=g, device=dev,
                   requires_grad=True)
    b = torch.rand(B, GEN, GEN, 3, generator=g, device=dev)

    def step():
        lpips_loss(params, a, b).backward()

    _without_syncs(step)


@pytest.mark.cuda
def test_stage1_step(dev):
    """A whole stage-1 step as the benchmark's stage-1 cell runs it: the
    dense chain, one 16^2 patch an item with its LPIPS term, Adam."""
    cfg = _cfg(use_pallas_mlp=True)
    state = stage1.init_state(cfg, B, dev)
    train_step = stage1.make_train_step(state, cfg, _lpips_params(dev, 5))
    batch = _batch(dev)
    g = torch.Generator(device=dev).manual_seed(6)
    _without_syncs(lambda: train_step(batch, g))
    assert state.step == 2


@pytest.mark.cuda
def test_cumprod_exclusive(dev):
    """Compositing's transmittance at a G step's size: forward and gradient
    as ``torch.cumprod``'s to the bit, with no host read."""
    g = torch.Generator(device=dev).manual_seed(7)
    alpha = torch.rand(32768, 80, generator=g, device=dev)
    alpha[:, 60:] = 1.0                      # opaque samples: x = 1e-10
    x = (1.0 - alpha + 1e-10).requires_grad_()
    x_ref = x.detach().clone().requires_grad_()
    cot = torch.randn(32768, 80, generator=g, device=dev)
    _without_syncs(lambda: cumprod_exclusive(x).backward(cot))
    cp = torch.cumprod(x_ref, dim=-1)
    want = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    want.backward(cot)
    x.grad = None
    got = cumprod_exclusive(x)
    got.backward(cot)
    assert torch.equal(got, want)
    assert torch.equal(x.grad, x_ref.grad)
