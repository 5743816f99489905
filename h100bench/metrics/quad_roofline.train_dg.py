"""The fused quad op's share of its roofline in the traced window, in %,
forward and backward together: an iteration runs it forward on each item's
coarse (R x num_coarse rows) and fine (R x num_fine) samples in the D
step's render and again in the G step's, and backward in the G step's."""

from h100bench.roofline import quad
from h100bench.roofline.field_mlp import from_config


def read(run):
    if run.traced is None:
        return None
    c = run.cell.config["config"]
    mlp = from_config(run.cell.config)
    nerf = c["nerf"]["train"]
    R = c["models"]["StyleUnet"]["inp_size"] ** 2
    H = c["models"]["coarse"].get("plane_res", 128)
    least = 0.0
    for n in (R * nerf["num_coarse"], R * nerf["num_fine"]):
        least += (2 * quad.call_least_s(mlp, n, H, backward=False)
                  + quad.call_least_s(mlp, n, H, backward=True))
    least *= c["gan"]["batch"] * run.traced.units
    return run.share(least, *quad.KERNELS)
