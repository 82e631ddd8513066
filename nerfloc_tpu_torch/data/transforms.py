"""Geometric and photometric frame transforms in numpy (counterpart of
nerfloc_tpu/data/transforms.py, with the OpenCV calls replaced by
data/imgproc.py's resamplers, which follow OpenCV's arithmetic).

Every transform co-updates (img, depth, Tcw, K, mask) so geometry stays
consistent. Parameters are drawn explicitly from a numpy Generator
(`sample_params`), and the same parameters are then applied to the query
and all its support frames:
  ResizeAndCrop   short side -> target, centre crop to a multiple
  PadToSize       pad bottom/right to one static shape
  RandomZoom      K-preserving zoom + pad/crop
  RandomRotate    in-plane rotation, premultiplies Tcw
  ColorJitter     brightness/contrast/saturation/hue
  DownSample, RandomCrop, Compose, build_transforms
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import imgproc


Frame = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
              Optional[np.ndarray]]  # img, depth, Tcw(3x4), K, mask


def scale_K(K: np.ndarray, sx: float, sy: float) -> np.ndarray:
    K = K.copy()
    K[0] *= sx
    K[1] *= sy
    return K


class Transform:
    def sample_params(self, rng: np.random.Generator) -> Dict:
        return {}

    def __call__(self, img, depth, Tcw, K, mask=None, params: Dict = None):
        raise NotImplementedError


class ResizeAndCrop(Transform):
    """Short side -> target_size, then center-crop so both dims are multiples
    of base_image_size; K adjusted."""

    def __init__(self, target_size: int, base_image_size: int):
        assert target_size % base_image_size == 0
        self.target_size = target_size
        self.base = base_image_size

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        h, w = img.shape[:2]
        scale = self.target_size / min(h, w)
        rh, rw = int(round(scale * h)), int(round(scale * w))
        img = imgproc.resize_area(img, rw, rh)
        depth = imgproc.resize_nearest(depth, rh, rw)
        if mask is not None:
            mask = imgproc.resize_nearest(mask.astype(np.uint8), rh, rw)
        K = scale_K(K, scale, scale)

        pw, ph = rw % self.base, rh % self.base
        if pw > 0:
            img = img[:, pw // 2: rw - (pw - pw // 2)]
            depth = depth[:, pw // 2: rw - (pw - pw // 2)]
            if mask is not None:
                mask = mask[:, pw // 2: rw - (pw - pw // 2)]
        if ph > 0:
            img = img[ph // 2: rh - (ph - ph // 2)]
            depth = depth[ph // 2: rh - (ph - ph // 2)]
            if mask is not None:
                mask = mask[ph // 2: rh - (ph - ph // 2)]
        K = K.copy()
        K[0, 2] -= pw // 2
        K[1, 2] -= ph // 2
        return img, depth, Tcw, K, mask


class PadToSize(Transform):
    """Pad (bottom/right) to a fixed (H, W) so every scene shares one static
    shape (the JAX package's addition: one compiled shape per dataset)."""

    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        h, w = img.shape[:2]
        if h > self.h or w > self.w:
            img, depth = img[:self.h, :self.w], depth[:self.h, :self.w]
            if mask is not None:
                mask = mask[:self.h, :self.w]
            h, w = img.shape[:2]
        pb, pr = self.h - h, self.w - w
        if pb or pr:
            img = np.pad(img, ((0, pb), (0, pr), (0, 0)))
            # padded pixels get depth 0 == invalid, so they never become
            # neural points and never supervise rendering
            depth = np.pad(depth, ((0, pb), (0, pr)))
            mask = np.pad(mask, ((0, pb), (0, pr))) if mask is not None else None
        return img, depth, Tcw, K, mask


def _zoom(x: np.ndarray, s: float, linear: bool) -> Tuple[np.ndarray, int, int]:
    """Resize content by s inside a fixed canvas (bilinear or nearest).
    Returns (image, dx, dy) principal-point shift."""
    h, w = x.shape[:2]
    th, tw = int(h * s), int(w * s)
    content = imgproc.resize_linear(x, tw, th) if linear else \
        imgproc.resize_nearest(x, th, tw)
    if s > 1:
        left, top = (tw - w) // 2, (th - h) // 2
        out = content[top:top + h, left:left + w]
        return out, -left, -top
    if s < 1:
        left, top = (w - tw) // 2, (h - th) // 2
        pad = [(top, h - th - top), (left, w - tw - left)] + \
              [(0, 0)] * (x.ndim - 2)
        return np.pad(content, pad), left, top
    return x, 0, 0


class RandomZoom(Transform):
    def __init__(self, aug_scale_min: float, aug_scale_max: float):
        self.lo, self.hi = aug_scale_min, aug_scale_max

    def sample_params(self, rng):
        return {"scale": float(rng.uniform(self.lo, self.hi))}

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        s = params["scale"]
        img, dx, dy = _zoom(img, s, linear=True)
        depth, _, _ = _zoom(depth, s, linear=False)
        if mask is not None:
            mask, _, _ = _zoom(mask.astype(np.uint8), s, linear=False)
        K = scale_K(K, s, s)
        K[0, 2] += dx
        K[1, 2] += dy
        return img, depth, Tcw, K, mask


class RandomRotate(Transform):
    """In-plane rotation of the image; the camera pose is pre-multiplied by
    the same in-plane rotation so geometry stays consistent."""

    def __init__(self, aug_rotation: float):
        self.max_deg = aug_rotation

    def sample_params(self, rng):
        return {"angle": float(rng.uniform(-self.max_deg, self.max_deg))}

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        angle = params["angle"]
        h, w = img.shape[:2]
        M = imgproc.rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
        img = imgproc.warp_affine(img, M, w, h, cubic=True)
        depth = imgproc.warp_affine(depth, M, w, h, cubic=False)
        if mask is not None:
            mask = imgproc.warp_affine(mask.astype(np.uint8), M, w, h, cubic=False)
        rad = -angle * math.pi / 180.0
        rot = np.eye(4)
        rot[0, 0] = math.cos(rad); rot[0, 1] = -math.sin(rad)
        rot[1, 0] = math.sin(rad); rot[1, 1] = math.cos(rad)
        Tcw_h = np.eye(4)
        Tcw_h[:3] = Tcw
        Tcw = (rot @ Tcw_h)[:3]
        return img, depth, Tcw, K, mask


class ColorJitter(Transform):
    """brightness/contrast/saturation/hue jitter with explicit params so the
    same jitter can be replayed (test-time jitter uses fixed parameter
    tables, video_dataset.VideoDataset)."""

    def __init__(self, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def sample_params(self, rng):
        return {
            "order": rng.permutation(4).tolist(),
            "brightness": float(rng.uniform(max(0, 1 - self.b), 1 + self.b)),
            "contrast": float(rng.uniform(max(0, 1 - self.c), 1 + self.c)),
            "saturation": float(rng.uniform(max(0, 1 - self.s), 1 + self.s)),
            "hue": float(rng.uniform(-self.h, self.h)),
        }

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        x = img.astype(np.float32)
        for op in params["order"]:
            if op == 0:
                x = np.clip(x * params["brightness"], 0, 255)
            elif op == 1:
                gray = x @ np.array([0.299, 0.587, 0.114])
                x = np.clip((x - gray.mean()) * params["contrast"]
                            + gray.mean(), 0, 255)
            elif op == 2:
                gray = (x @ np.array([0.299, 0.587, 0.114]))[..., None]
                x = np.clip(gray + (x - gray) * params["saturation"], 0, 255)
            else:
                hsv = imgproc.rgb_to_hsv(x.astype(np.uint8)).astype(np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(params["hue"] * 180)) % 180
                x = imgproc.hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32)
        return x.astype(img.dtype), depth, Tcw, K, mask


class DownSample(Transform):
    """Resize everything by 1/factor, scaling K."""

    def __init__(self, factor: float = 2.0):
        self.factor = factor

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        h, w = img.shape[:2]
        nh, nw = int(h / self.factor), int(w / self.factor)
        img = imgproc.resize_area(img, nw, nh)
        depth = imgproc.resize_nearest(depth, nh, nw)
        if mask is not None:
            mask = imgproc.resize_nearest(mask.astype(np.uint8), nh, nw)
        K = scale_K(K, nw / w, nh / h)
        return img, depth, Tcw, K, mask


class RandomCrop(Transform):
    """Crop a random sub-window of ratio in [min_ratio, max_ratio], shifting
    the principal point."""

    def __init__(self, min_ratio: float = 0.8, max_ratio: float = 1.0):
        self.lo, self.hi = min_ratio, max_ratio

    def sample_params(self, rng):
        s = float(rng.uniform(self.lo, self.hi))
        return {"scale": s, "corner": float(rng.uniform(0.0, 1.0 - s))}

    def __call__(self, img, depth, Tcw, K, mask=None, params=None):
        h, w = img.shape[:2]
        s, c = params["scale"], params["corner"]
        x, y = int(w * c), int(h * c)
        nh, nw = int(h * s), int(w * s)
        img = img[y: y + nh, x: x + nw]
        depth = depth[y: y + nh, x: x + nw]
        if mask is not None:
            mask = mask[y: y + nh, x: x + nw]
        K = K.copy()
        K[0, 2] -= x
        K[1, 2] -= y
        return img, depth, Tcw, K, mask


class Compose:
    def __init__(self, transforms: List[Transform]):
        self.transforms = transforms

    def sample_params(self, rng: np.random.Generator) -> List[Dict]:
        return [t.sample_params(rng) for t in self.transforms]

    def __call__(self, img, depth, Tcw, K, mask=None,
                 params: Optional[List[Dict]] = None):
        if params is None:
            params = [{} for _ in self.transforms]
        for t, p in zip(self.transforms, params):
            img, depth, Tcw, K, mask = t(img, depth, Tcw, K, mask, params=p)
        return img, depth, Tcw, K, mask


def build_transforms(spec: List[Dict]) -> Compose:
    """Build from the data-YAML declaration format:
    [{'ResizeAndCrop': {'target_size': 256, ...}}, ...]"""
    reg = {c.__name__: c for c in
           (ResizeAndCrop, PadToSize, RandomZoom, RandomRotate, ColorJitter,
            DownSample, RandomCrop)}
    out = []
    for item in spec or []:
        (name, kwargs), = item.items()
        out.append(reg[name](**(kwargs or {})))
    return Compose(out)
