"""Host-side dataset: JSON split -> rays + condition images.

The port's own copy of ``havatar_tpu/data/dataset.py`` (numpy only; image
files go through ``data/image_io.py``).

Behavioral specs:
* stage-1 ray loader ``MultiView_ImgDataset`` (dataloader/dataloader.py:36-218)
  — one item per (frame, view); importance-samples 1024 rays (p=0.95 on the
  mask) or one 64² patch for LPIPS; 12-channel ray layout
  [o(3), d(3), near, far, bg(3), mask] (dataloader.py:179);
* stage-2 full-image loader (dataloader/dataloaderSR.py:23-183) — ALL rays of
  the (downsampled 128²) image + full-res 512² GT with white-background
  compositing;
* 7-channel condition images render(3)+normal(3)+mask(1)
  (dataloader.py:220-230); inverse head transform [4,3]
  (dataloader.py:215-216).

Design: pure numpy on the host (the device never touches file IO); the
Loader yields contiguous batched arrays ready for one copy to the device. Deterministic
given a seed. No worker processes are needed at these rates, but the Loader
supports a thread-pool prefetcher for training.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from havatar_tpu_torch.data.image_io import imread_rgb, resize
from havatar_tpu_torch.ops.rays import (
    get_rays_np,
    make_ray_importance_sampling_map,
)


def load_render_cond(inst_dir: str, view: str, res: int) -> np.ndarray:
    """render(3)+normal(3)+mask(1), [H, W, 7] float32 in [0,1]
    (spec: dataloader.py:220-230)."""
    normal = imread_rgb(os.path.join(
        inst_dir, f"ortho_{view}_normal_256_baseGama.png"))
    if normal.shape[0] != res:
        normal = resize(normal, size=res, area=False)
    mask = (np.linalg.norm(normal.astype(np.float32), axis=-1) > 0.0)
    render = imread_rgb(os.path.join(
        inst_dir, f"ortho_{view}_render_256_baseGama.png"))
    if render.shape[0] != res:
        render = resize(render, size=res, area=False)
    return np.concatenate([
        render.astype(np.float32) / 255.0,
        normal.astype(np.float32) / 255.0,
        mask.astype(np.float32)[..., None],
    ], axis=-1)


def inv_head_transform(head_transformation: np.ndarray) -> np.ndarray:
    """[4, 4] right-multiplied head transform -> [4, 3] inverse
    (spec: dataloader.py:215-216)."""
    ht = np.asarray(head_transformation, dtype=np.float32)[:3]
    rotation, translation = ht.T[:3, :3], ht.T[-1:]
    return np.concatenate([np.linalg.inv(rotation), -translation], 0).astype(np.float32)


class AvatarDataset:
    """Parses the ``sv_v31_all.json``-style split and produces per-item
    numpy dicts. ``full_image=False`` gives the stage-1 sampled-ray behavior;
    ``full_image=True`` the stage-2/inference full-image behavior."""

    def __init__(self, split_file: str, mode: str, cfg, down_sample: float = 1.0,
                 white_bg: bool = True, full_image: bool = False,
                 seed: int = 0):
        assert mode in ("train", "val", "test")
        self.mode = mode
        self.cfg = cfg
        self.full_image = full_image
        self.down_sample = down_sample
        self.white_bg = white_bg
        self.rng = np.random.RandomState(seed)

        self.num_random_rays = cfg.dataset.num_random_rays
        self.patch_rgb = bool(cfg.experiment.get("patch_rgb", False))
        self.patch_size, self.n_patches = (64, 1) if self.patch_rgb else (11, 5)
        self.cond_res = cfg.dataset.cond_render_res
        # scalar, or a dict keyed by view_name for per-view thresholds
        # (spec: dataloader.py:47,156)
        self.mask_thresh = cfg.dataset.get("mask_thresh", 127.5)

        meta = json.loads(open(split_file).read())
        self.img_w = self.img_h = int(meta["img_res"])
        self.full_res = self.img_w
        self.mv_intrinsics = np.asarray(meta["mutiview_intr_ls"], dtype=np.float32)
        if down_sample < 1:
            self.mv_intrinsics = self.mv_intrinsics.copy()
            self.mv_intrinsics[:, :2] *= down_sample
            self.img_w = int(self.img_w * down_sample)
            self.img_h = int(self.img_h * down_sample)
        self.view_num = self.mv_intrinsics.shape[0]

        self.bg_paths = meta.get("bg_path")
        self.frames: List[Dict[str, Any]] = []
        for fr in meta["frames"]:
            for vidx, vinfo in enumerate(fr["mutiview_info_ls"]):
                if vinfo.get("view_name") == "8":
                    continue
                item = dict(fr)
                item["vidx"] = vidx
                self.frames.append(item)
        self.frames.sort(key=lambda x: x["fidx"])

    def __len__(self) -> int:
        return len(self.frames)

    # -- internals ----------------------------------------------------------

    def _background(self, view_idx: int) -> np.ndarray:
        if self.white_bg or not self.bg_paths:
            return np.ones((self.img_h, self.img_w, 3), dtype=np.float32)
        bg = imread_rgb(self.bg_paths[view_idx])
        if self.down_sample < 1:
            bg = resize(bg, size=self.img_h)
        return bg.astype(np.float32) / 255.0

    def _select_pixels(self, mask: Optional[np.ndarray]) -> np.ndarray:
        """Returns [N, 2] (y, x) pixel indices."""
        H, W = self.img_h, self.img_w
        if self.mode != "train" or self.full_image:
            yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
            return np.stack([yy.ravel(), xx.ravel()], -1)
        if self.patch_rgb:
            return self._sample_patch(mask)
        prob = make_ray_importance_sampling_map(mask, p=0.95)
        flat = self.rng.choice(H * W, size=self.num_random_rays,
                               replace=False, p=prob.ravel())
        return np.stack([flat // W, flat % W], -1)

    def _sample_patch(self, mask: np.ndarray) -> np.ndarray:
        """n_patches patches of patch_size² pixels centered on mask samples
        (spec: dataloader.py:98-127, erode=False, p=1.0 in the stage-1 call)."""
        H, W, ps = self.img_h, self.img_w, self.patch_size
        valid = np.zeros_like(mask)
        valid[ps // 2: H - ps // 2, ps // 2: W - ps // 2] = \
            mask[ps // 2: H - ps // 2, ps // 2: W - ps // 2]
        prob = make_ray_importance_sampling_map(valid, p=1.0)
        flat = self.rng.choice(H * W, size=self.n_patches, replace=False,
                               p=prob.ravel())
        y0, x0 = flat // W, flat % W
        offs = np.arange(ps) - ps // 2
        oy, ox = np.meshgrid(offs, offs, indexing="xy")
        ys = (y0[:, None] + oy.ravel()[None]).ravel()
        xs = (x0[:, None] + ox.ravel()[None]).ravel()
        return np.stack([ys, xs], -1)

    # -- public -----------------------------------------------------------

    def load_item(self, idx: int) -> Dict[str, Any]:
        fr = self.frames[idx]
        vidx = fr["vidx"]
        vinfo = fr["mutiview_info_ls"][vidx]
        pose = np.asarray(vinfo["transform_matrix"], dtype=np.float32)
        if "cam_K" in vinfo:
            cam_K = np.asarray(vinfo["cam_K"], dtype=np.float32).copy()
            if self.down_sample < 1:
                cam_K[:2] *= self.down_sample
        else:
            cam_K = self.mv_intrinsics[vidx]

        ray_o, ray_d = get_rays_np(self.img_h, self.img_w, cam_K, pose[:3, :4])

        mask = None
        if self.mode != "test":
            m = imread_rgb(vinfo["mask_path"])
            if self.full_image:
                mask_full = (m[:, :, 0] > 127).astype(np.float32)
                mask = (resize(mask_full, scale=self.down_sample)
                        if self.down_sample < 1 else mask_full)
            else:
                if self.down_sample < 1:
                    m = resize(m, scale=self.down_sample)
                thr = (self.mask_thresh[vinfo["view_name"]]
                       if isinstance(self.mask_thresh, dict)
                       else self.mask_thresh)
                mask = (m[:, :, 0] > thr).astype(np.float32)

        sel = self._select_pixels(mask)
        ys, xs = sel[:, 0], sel[:, 1]

        bg = self._background(vidx)
        ro, rd = ray_o[ys, xs], ray_d[ys, xs]
        rbg = bg[ys, xs]

        # near/far from the original (un-normalized) camera distance
        # (spec: dataloader.py:174-177)
        t_ori = np.asarray(vinfo["transform_matrix_ori"], dtype=np.float32)
        dist = float(np.linalg.norm(t_ori[:3, -1]))
        near = dist + self.cfg.dataset.near * self.cfg.dataset.length
        far = dist + self.cfg.dataset.far * self.cfg.dataset.length
        ones = np.ones((sel.shape[0], 1), dtype=np.float32)

        # mask channel only in TRAIN mode (12-ch); val/test are 11-ch
        # (spec: dataloader.py:179-180)
        parts = [ro, rd, near * ones, far * ones, rbg]
        if mask is not None and self.mode == "train":
            parts.append(mask[ys, xs][:, None])
        rays = np.concatenate(parts, axis=1).astype(np.float32)

        item: Dict[str, Any] = {
            "fidx": fr["fidx"],
            "vidx": int(vinfo["view_name"]),
            "dataset_idx": idx,
            "mv_rays": rays,
        }

        if self.mode != "test":
            img = imread_rgb(vinfo["file_path"])
            if self.full_image:
                # stage-2: GT stays at FULL resolution, white-bg composited
                # with the full-res mask (spec: dataloaderSR.py:124-129)
                if self.white_bg:
                    img = img.copy()
                    img[mask_full == 0] = 255
                gt = img.astype(np.float32) / 255.0
                item["gt_color"] = gt.reshape(-1, 3)
            else:
                if self.down_sample < 1:
                    img = resize(img, scale=self.down_sample)
                gt = img.astype(np.float32) / 255.0
                gt = gt * mask[..., None] + bg * (1.0 - mask[..., None])
                item["gt_color"] = gt[ys, xs]

        inst = fr["inst_dir"]
        for view in ("front", "left", "right"):
            item[f"{view}_render_cond"] = load_render_cond(inst, view, self.cond_res)
        item["inv_head_T"] = inv_head_transform(fr["head_transformation"])
        return item


class Loader:
    """Batching iterator over an AvatarDataset with optional shuffling and
    threaded prefetch. Yields dicts of stacked numpy arrays."""

    def __init__(self, dataset: AvatarDataset, batch_size: int = 2,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 drop_last: bool = True, num_workers: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = (dataset.mode == "train") if shuffle is None else shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate(self, items: List[Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k in items[0]:
            v0 = items[0][k]
            if isinstance(v0, np.ndarray):
                out[k] = np.stack([it[k] for it in items])
            else:
                out[k] = np.asarray([it[k] for it in items])
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i:i + self.batch_size]
            for i in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size)
        ]
        if self.num_workers > 1:
            pool = ThreadPoolExecutor(self.num_workers)
            futs = [pool.submit(lambda b: self._collate(
                [self.ds.load_item(i) for i in b]), b) for b in batches]
            try:
                for f in futs:
                    yield f.result()
            finally:
                pool.shutdown(wait=False)
        else:
            for b in batches:
                yield self._collate([self.ds.load_item(i) for i in b])


def infinite(loader: Loader) -> Iterator[Dict[str, Any]]:
    """Endless epoch cycler (spec analogue: utils/styleUnet_util.py:59-62)."""
    while True:
        yield from loader
