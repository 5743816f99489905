"""Device ms a step of the gathers' backward (the plane and skinning-volume
lookups' index accumulation), by kernel name in the traced window."""

KERNELS = ("indexing_backward", "index_put", "scatter_add",
           "index_add", "embedding_backward")


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    s = t.kernel_s(*KERNELS)
    return s / t.units * 1e3 if s > 0 else None
