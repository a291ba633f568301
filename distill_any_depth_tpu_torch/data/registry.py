"""Multi-dataset evaluation registry (KITTI / ETH3D / DIODE / ScanNet / NYU).

The port's own copy of distill_any_depth_tpu/data/registry.py (which
imports the JAX package's ``data.nyu`` and ``data.transforms``): a typed
``DatasetSpec`` per benchmark with its depth decoding, metric depth range
and valid-mask crop policy, and one file-list-driven loader
(``FileListDataset``) that ``cli.evaluate --dataset <name>`` drives.

Conventions follow the geobench/Marigold evaluation lineage:

- split lists are text files of whitespace-separated relative paths
  ``rgb_path depth_path`` (extra columns ignored, ``#`` comments allowed);
- KITTI: uint16 PNG / 256, range [1e-5, 80] m, KB benchmark crop 352x1216
  bottom-center, eigen/garg fractional valid crops;
- NYU / ScanNet: uint16 PNG / 1000, range [1e-3, 10] m, NYU additionally
  uses the eigen border crop (rows 45:471, cols 41:601 at 480x640);
- DIODE: ``.npy`` float depth, range [0.6, 350] m;
- ETH3D: raw little-endian float32 files at the native 4032x6048 (or any
  ``.pfm``/``.npy``), range [1e-5, inf).

Invalid pixels are zeroed at native resolution; the metrics' ``mask = gt >
0`` (``eval/metrics``) then excludes them, and the NEAREST depth resize
keeps the zeros. ``cv2`` is imported where a file is read.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from distill_any_depth_tpu_torch.data.nyu import NYUSample
from distill_any_depth_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, Resize

__all__ = ["DatasetSpec", "DATASETS", "FileListDataset", "get_spec"]

# Fractional valid-mask crops for KITTI (Eigen & Garg evaluation protocols).
_KITTI_EIGEN_CROP = (0.3324324, 0.91351351, 0.0359477, 0.96405229)
_KITTI_GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
# NYU eigen border crop in pixels at the native 480x640.
_NYU_EIGEN_CROP = (45, 471, 41, 601)


@dataclass(frozen=True)
class DatasetSpec:
    """One eval benchmark: decoding + masking policy (no file IO itself)."""

    name: str
    disp_name: str           # the reference YAML's disp_name
    filenames: str           # default split-list path, relative to data_dir
    min_depth: float
    max_depth: float
    depth_scale: float = 256.0         # divisor for integer PNG depth
    valid_mask_crop: str | None = None  # None | "eigen" | "garg"
    benchmark_crop: tuple[int, int] | None = None  # KITTI KB crop (h, w)
    raw_depth_shape: tuple[int, int] | None = None  # extensionless raw f32


DATASETS: dict[str, DatasetSpec] = {
    "nyu": DatasetSpec(
        name="nyu", disp_name="nyu_test_full",
        filenames="nyu/labeled/filename_list_test.txt",
        min_depth=1e-3, max_depth=10.0, depth_scale=1000.0,
        valid_mask_crop="eigen",
    ),
    "kitti": DatasetSpec(
        name="kitti", disp_name="kitti_eigen_test_full",
        filenames="kitti/eigen_test_files_with_gt.txt",
        min_depth=1e-5, max_depth=80.0, depth_scale=256.0,
        valid_mask_crop="eigen", benchmark_crop=(352, 1216),
    ),
    "eth3d": DatasetSpec(
        name="eth3d", disp_name="eth3d_full",
        filenames="eth3d/eth3d_filename_list.txt",
        min_depth=1e-5, max_depth=np.inf,
        raw_depth_shape=(4032, 6048),
    ),
    "diode": DatasetSpec(
        name="diode", disp_name="diode_val_all",
        filenames="diode/diode_val_all_filename_list.txt",
        min_depth=0.6, max_depth=350.0,
    ),
    "scannet": DatasetSpec(
        name="scannet", disp_name="scannet_val_800",
        filenames="scannet/scannet_val_sampled_list_800_1.txt",
        min_depth=1e-3, max_depth=10.0, depth_scale=1000.0,
    ),
}
DATASETS["nyu_v2"] = DATASETS["nyu"]  # the YAML's `name:` field


def get_spec(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown eval dataset {name!r}; known: {sorted(set(DATASETS))}"
        ) from None


def _read_depth(path: str, spec: DatasetSpec) -> np.ndarray:
    import cv2

    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        d = np.load(path)
        return np.squeeze(d).astype(np.float32)
    if ext == ".pfm":
        from distill_any_depth_tpu_torch.utils.image_util import read_pfm

        d, _scale = read_pfm(path)
        return np.ascontiguousarray(d).astype(np.float32)
    if ext in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
        if d.ndim == 3:
            d = d[..., 0]
        if np.issubdtype(d.dtype, np.integer):
            return d.astype(np.float32) / spec.depth_scale
        return d.astype(np.float32)
    if spec.raw_depth_shape is not None:
        d = np.fromfile(path, dtype="<f4")
        return d.reshape(spec.raw_depth_shape)
    raise ValueError(f"cannot decode depth file {path!r} for {spec.name}")


def _valid_mask(depth: np.ndarray, spec: DatasetSpec) -> np.ndarray:
    mask = (depth > spec.min_depth) & (depth < spec.max_depth)
    mask &= np.isfinite(depth)
    h, w = depth.shape
    if spec.valid_mask_crop is not None:
        border = np.zeros_like(mask)
        if spec.name in ("nyu", "nyu_v2"):
            # pixel crop defined at native 480x640; scale if resized upstream
            t, b, l, r = _NYU_EIGEN_CROP
            t, b = int(t * h / 480), int(b * h / 480)
            l, r = int(l * w / 640), int(r * w / 640)
        else:
            ft, fb, fl, fr = (
                _KITTI_GARG_CROP
                if spec.valid_mask_crop == "garg"
                else _KITTI_EIGEN_CROP
            )
            t, b = int(ft * h), int(fb * h)
            l, r = int(fl * w), int(fr * w)
        border[t:b, l:r] = True
        mask &= border
    return mask


class FileListDataset:
    """Split-list-driven eval dataset for any registered benchmark.

    Yields ``NYUSample``s (so ``data.nyu.iterate_batches`` works unchanged).
    Two resolution protocols:

    - ``native_resolution=True`` (default for every benchmark except NYU):
      the image is keep-aspect resized (lower_bound, multiple of 14 — the
      reference's own inference sizing, midas/transforms.py Resize) and the
      GT depth is returned **untouched at native resolution** (after the
      benchmark crop + invalid-pixel zeroing). The eval harness upsamples
      the *prediction* to GT resolution (eval/evaluate.py) — the
      geobench/Marigold protocol the reference's dataset YAMLs descend from
      (configs/dataset_configs/single/data_kitti_eigen_test.yaml in the
      reference). A square-resized KITTI (aspect 3.45:1)
      would produce numbers comparable to nothing published.
    - ``native_resolution=False`` (NYU default): image AND depth square-
      resized to ``image_size`` (depth NEAREST, invalids zeroed at native
      resolution first so zeros survive) — reference eval parity
      (tools/evaluate.py:179-191 resizes both to a square).

    ``valid_mask_crop`` overrides the spec's policy (``None``/"eigen"/
    "garg") — the eigen vs garg choice on KITTI.
    """

    def __init__(
        self,
        spec: DatasetSpec | str,
        data_dir: str,
        image_size: int = 392,
        filenames: str | None = None,
        native_resolution: bool | None = None,
        valid_mask_crop: str | None = "default",
    ):
        self.spec = get_spec(spec) if isinstance(spec, str) else spec
        if valid_mask_crop != "default":
            import dataclasses

            self.spec = dataclasses.replace(
                self.spec, valid_mask_crop=valid_mask_crop
            )
        if native_resolution is None:
            native_resolution = self.spec.name not in ("nyu", "nyu_v2")
        self.native_resolution = native_resolution
        self.data_dir = data_dir
        self.image_size = image_size
        list_path = filenames or os.path.join(data_dir, self.spec.filenames)
        if not os.path.isabs(list_path) and not os.path.exists(list_path):
            list_path = os.path.join(data_dir, list_path)
        with open(list_path) as f:
            rows = [
                ln.split() for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")
            ]
        self.pairs = [(r[0], r[1]) for r in rows]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, index: int) -> NYUSample:
        import cv2

        spec = self.spec
        rgb_rel, depth_rel = self.pairs[index]
        rgb = cv2.imread(os.path.join(self.data_dir, rgb_rel))
        if rgb is None:
            raise FileNotFoundError(rgb_rel)
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
        depth = _read_depth(os.path.join(self.data_dir, depth_rel), spec)

        if spec.benchmark_crop is not None:  # KITTI KB crop, bottom-center
            ch, cw = spec.benchmark_crop
            h, w = depth.shape
            top, left = max(h - ch, 0), max((w - cw) // 2, 0)
            depth = depth[top : top + ch, left : left + cw]
            rh, rw = rgb.shape[:2]
            top, left = max(rh - ch, 0), max((rw - cw) // 2, 0)
            rgb = rgb[top : top + ch, left : left + cw]

        depth = np.where(_valid_mask(depth, spec), depth, 0.0).astype(np.float32)

        if self.native_resolution:
            h, w = rgb.shape[:2]
            nw, nh = Resize(self.image_size, self.image_size, ensure_multiple_of=14,
                            keep_aspect_ratio=True).get_size(w, h)
            image = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_CUBIC)
            image = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            return NYUSample(image=image, depth=depth, rgb_path=rgb_rel)

        size = (self.image_size, self.image_size)
        image = cv2.resize(rgb, size, interpolation=cv2.INTER_CUBIC)
        image = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        depth = cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST)
        return NYUSample(image=image, depth=depth, rgb_path=rgb_rel)
