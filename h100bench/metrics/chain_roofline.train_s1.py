"""The fused dense chain's share of its roofline in the traced window, in
%, forward and backward on a step's coarse (B x R x num_coarse rows) and
fine (B x R x num_fine) samples."""

from h100bench.roofline import chain
from h100bench.roofline.field_mlp import from_config


def read(run):
    if run.traced is None:
        return None
    c, tr = run.cell.config["config"], run.cell.traffic
    mlp = from_config(run.cell.config)
    nerf = c["nerf"]["train"]
    rays = tr["batch"] * tr["patch"] ** 2
    least = sum(chain.call_least_s(mlp, rays * s, backward=b)
                for s in (nerf["num_coarse"], nerf["num_fine"])
                for b in (False, True))
    return run.share(least * run.traced.units, *chain.KERNELS)
