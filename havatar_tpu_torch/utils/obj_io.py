"""Minimal OBJ mesh IO and the skinning volume's debug dump.

The port's own copy of ``havatar_tpu/utils/obj_io.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def save_obj(path: str, v: np.ndarray, f: Optional[np.ndarray] = None,
             vc: Optional[np.ndarray] = None) -> None:
    """Write vertices (optionally with per-vertex colours) and 1-based
    faces."""
    v = np.asarray(v)
    with open(path, "w") as fh:
        for i in range(v.shape[0]):
            if vc is not None:
                fh.write("v %f %f %f %f %f %f\n" % (*v[i], *np.asarray(vc)[i]))
            else:
                fh.write("v %f %f %f\n" % tuple(v[i]))
        if f is not None:
            for tri in np.asarray(f):
                fh.write("f %d %d %d\n" % tuple(tri))


def load_obj(path: str) -> Dict[str, np.ndarray]:
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vals = [float(x) for x in parts[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    colors.append(vals[3:6])
            elif parts[0] == "f":
                faces.append([int(x.split("/")[0]) for x in parts[1:4]])
    out = {"v": np.asarray(verts, np.float32)}
    if colors:
        out["vc"] = np.asarray(colors, np.float32)
    if faces:
        out["f"] = np.asarray(faces, np.int32)
    return out


def visualize_skin_volume(renderer, path: str, steps: int = 20) -> None:
    """Dump the head-follow weight channel of ``renderer``'s skinning volume
    as a coloured point cloud: ``steps``^3 grid points of the skinning box,
    each coloured by its weight."""
    from havatar_tpu_torch.models.skinning import make_volume_pts

    skin = renderer.headpose_skin_net
    device = next(renderer.parameters()).device
    with torch.no_grad():
        pts = make_volume_pts(steps=steps, warp=skin.warp, device=device)
        w = skin.sample_weight(pts).float()
    vc = w.cpu().numpy() * np.ones((1, 3), np.float32)
    save_obj(path, pts.cpu().numpy(), vc=vc)
