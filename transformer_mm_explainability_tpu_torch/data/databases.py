"""MMF-style annotation / feature databases (C29 datasets layer).

The port's copy of ``transformer_mm_explainability_tpu/data/databases.py``
(numpy; ``lmdb`` and PIL imported lazily): importing that module would load
the JAX package.

Rethink of VisualBERT/mmf/datasets/databases/*: the torch ``Dataset``
machinery disappears (host-side data prep feeds the device programs via
plain numpy), but the on-disk formats and lookup
semantics are kept exactly so published MMF data drops in:

  AnnotationDatabase   — mmf annotation_database.py:10-101 (npy imdb
                         with header row, {metadata,data} dicts, jsonl,
                         json; the answers/valid_answers aliasing hacks)
  FeatureReader        — readers/feature_readers.py:28-96 dispatch
  PaddedFrcnnFeatureReader — feature_readers.py:140-192 (npy +
                         ``*_info.npy`` merge, pad to max_features)
  LmdbFeatureReader    — feature_readers.py:195-242 (gated: the lmdb
                         package is optional; everything this repo
                         publishes uses npy dirs or the native TSV op)
  FeaturesDatabase     — features_database.py:15-123 (multi-dir
                         readers, feature_path fallback from image
                         path, the visual-genome ``*.npy`` renaming)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def load_feat(path: str) -> np.ndarray:
    """feature_readers.load_feat (:14-25): ``.npy`` through numpy,
    ``.pt``/``.pth`` through ``torch.load(weights_only=True)`` (tensors
    only, no pickled code), returned as numpy."""
    if path.endswith("npy"):
        return np.load(path, allow_pickle=True)
    if path.endswith(("pth", ".pt")):
        import torch

        feat = torch.load(path, map_location="cpu", weights_only=True)
        return feat.numpy() if isinstance(feat, torch.Tensor) else feat
    raise AssertionError(f"Unknown feature type: {path}")


class AnnotationDatabase:
    """Sequence view over an MMF annotation file."""

    def __init__(self, path: str):
        self.metadata: Dict[str, Any] = {}
        self.start_idx = 0
        if path.endswith(".npy"):
            self._load_npy(path)
        elif path.endswith(".jsonl"):
            with open(path, encoding="utf-8") as f:
                self.data = [json.loads(line) for line in f if line.strip()]
        elif path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                blob = json.load(f)
            self.metadata = blob.get("metadata", {})
            self.data = blob.get("data", [])
            if len(self.data) == 0:
                raise RuntimeError("Dataset is empty")
        else:
            raise ValueError(f"Unknown annotation format: {path}")

    def _load_npy(self, path: str):
        db = np.load(path, allow_pickle=True)
        if isinstance(db, np.ndarray) and db.dtype == object and (
                db.ndim == 0):
            db = db.item()
        if isinstance(db, dict):
            self.metadata = db.get("metadata", {})
            self.data = db.get("data", [])
            if len(self.data) == 0:
                self.data = db
        else:
            # old imdb layout: row 0 is a metadata header unless the
            # first row already looks like a sample
            self.metadata = {"version": 1}
            self.data = db
            first = db[0] if len(db) else {}
            if not (isinstance(first, dict) and "image_id" in first):
                self.start_idx = 1

    def __len__(self) -> int:
        return len(self.data) - self.start_idx

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = self.data[idx + self.start_idx]
        data = dict(item)
        # older-IMDB aliases (annotation_database.py:85-95)
        if "answers" not in data:
            if "all_answers" in data and "valid_answers" not in data:
                data["answers"] = data["all_answers"]
            if "valid_answers" in data:
                data["answers"] = data["valid_answers"]
        if "answers" in data and len(data["answers"]) and (
                data["answers"][-1] == "<copy>"):
            data["answers"] = data["answers"][:-1]
        return data


class PaddedFrcnnFeatureReader:
    """feature_readers.PaddedFasterRCNNFeatureReader (:140-192)."""

    def __init__(self, max_loc: int):
        self.max_loc = max_loc

    def _load(self, path: str) -> Dict[str, Any]:
        info: Dict[str, Any] = {"features": load_feat(path)}
        info_path = f"{path.split('.npy')[0]}_info.npy"
        if os.path.exists(info_path):
            info.update(load_feat(info_path).item())
        return info

    def read(self, path: str):
        info = self._load(path)
        feat = info["features"]
        if feat.size == 1 and isinstance(feat.item(0), dict):
            # packed single-dict layout (:160-178)
            item = feat.item()
            if "image_text" in item:
                info["image_text"] = item["image_text"]
                info["is_ocr"] = item["image_bbox_source"]
                feat = item["image_feat"]
            if "info" in item:
                if "image_text" in item["info"]:
                    info.update(item["info"])
                feat = item["feature"]
        if feat.ndim > 2:  # e.g. ResNet152 grids → [H*W, C] (:180-183)
            feat = feat.reshape(-1, feat.shape[-1])
        n, dim = feat.shape
        padded = np.zeros((self.max_loc, dim), np.float32)
        padded[:n] = feat[:self.max_loc]
        del info["features"]
        info["max_features"] = np.int64(n)
        return padded, info


class LmdbFeatureReader(PaddedFrcnnFeatureReader):
    """feature_readers.LMDBFeatureReader (:195-242). Requires the
    optional ``lmdb`` package (not shipped in this image — MMF's LMDB
    stores can be unpacked to npy dirs, or repacked through the native
    TSV reader, without it)."""

    def __init__(self, max_loc: int, db_path: str):
        super().__init__(max_loc)
        self.db_path = db_path
        self.env = None
        if not os.path.exists(db_path):
            raise RuntimeError(f"LMDB path doesn't exist: {db_path}")

    def _init_db(self):
        import pickle

        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "reading .lmdb feature stores needs the optional 'lmdb' "
                "package; unpack the store to an npy directory instead "
                "(every published MMF store also ships npy)") from e
        self.env = lmdb.open(
            self.db_path, subdir=os.path.isdir(self.db_path),
            readonly=True, lock=False, readahead=False, meminit=False)
        with self.env.begin(write=False, buffers=True) as txn:
            self.image_ids = pickle.loads(txn.get(b"keys"))
            self.image_id_indices = {
                self.image_ids[i]: i for i in range(len(self.image_ids))}

    def _load(self, path: str) -> Dict[str, Any]:
        import pickle

        if self.env is None:
            self._init_db()
        split = os.path.relpath(path, self.db_path).split(".npy")[0]
        try:
            image_id = int(split.split("_")[-1])
            idx = self.image_id_indices[str(image_id).encode()]
        except (ValueError, KeyError):
            idx = self.image_id_indices[str(split).encode()]
        with self.env.begin(write=False, buffers=True) as txn:
            return pickle.loads(txn.get(self.image_ids[idx]))


class FeatureReader:
    """Path-based dispatch (feature_readers.py:28-96): .lmdb base paths
    go to the LMDB reader, npy files to the padded FRCNN reader (or raw
    when max_features is None)."""

    DEFAULT_MAX_FEATURES = 100

    def __init__(self, base_path: str, max_features: Optional[int] = 100):
        self.base_path = base_path
        self.max_features = max_features
        if base_path.endswith(".lmdb"):
            # the LMDB reader always pads, so it needs a concrete cap
            # (the reference's feature_readers default); max_features
            # None would crash np.zeros((None, dim)) at read time
            self._reader = LmdbFeatureReader(
                max_features or self.DEFAULT_MAX_FEATURES, base_path)
        elif max_features is None:
            self._reader = None  # raw npy
        else:
            self._reader = PaddedFrcnnFeatureReader(max_features)

    def read(self, feat_path: str):
        if not feat_path.endswith(("npy", "pth", ".pt")):
            return None
        full = (feat_path if self.base_path.endswith(".lmdb")
                else os.path.join(self.base_path, feat_path))
        if self._reader is None:
            return load_feat(full), None
        return self._reader.read(full)


class FeaturesDatabase:
    """features_database.FeaturesDatabase (:15-123) minus the torch
    Dataset base: __getitem__ joins the annotation db's feature_path to
    {image_feature_i, image_info_i} dicts."""

    def __init__(self, path: str,
                 annotation_db: Optional[AnnotationDatabase] = None,
                 feature_key: str = "feature_path",
                 max_features: int = 100,
                 return_info: bool = True):
        self.feature_readers: List[FeatureReader] = [
            FeatureReader(p.strip(), max_features)
            for p in path.split(",")]
        self.annotation_db = annotation_db
        self.feature_key = feature_key
        self._should_return_info = return_info

    def __len__(self) -> int:
        assert self.annotation_db is not None, "no annotation db attached"
        return len(self.annotation_db)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        assert self.annotation_db is not None, "no annotation db attached"
        return self.get(self.annotation_db[idx])

    def get(self, item: Dict[str, Any]) -> Dict[str, Any]:
        feature_path = item.get(self.feature_key)
        if feature_path is None:
            feature_path = self._feature_path_from_image(item)
        return self.from_path(feature_path)

    def from_path(self, path: str) -> Dict[str, Any]:
        # visual-genome stores name features "<prefix>_<imageid>.npy"
        # (features_database.py:103-105)
        if "genome" in path and path.endswith(".npy"):
            path = str(int(path.split("_")[-1].split(".")[0])) + ".npy"
        out: Dict[str, Any] = {}
        for i, reader in enumerate(self.feature_readers):
            feats, info = reader.read(path)
            out[f"image_feature_{i}"] = feats
            if self._should_return_info:
                out[f"image_info_{i}"] = info
        return out

    @staticmethod
    def _feature_path_from_image(item: Dict[str, Any]) -> str:
        image_path = item.get("image_path", item.get("image_name",
                                                     item.get("image_id")))
        if isinstance(image_path, int):
            return f"{image_path}.npy"
        return ".".join(str(image_path).split(".")[:-1] or
                        [str(image_path)]) + ".npy"


# ---------------------------------------------------------------------------
# ImageDatabase (image_database.py:32-205) — raw-pixel path for models
# that don't consume precomputed region features
# ---------------------------------------------------------------------------

_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                   ".tif", ".tiff", ".webp")

_IMAGE_KEY_CANDIDATES = ["Flickr30kID", "Flikr30kID", "identifier",
                         "image_path", "image_name", "img", "image_id"]


def _possible_image_path(path: str) -> Optional[str]:
    """get_possible_image_paths (:13-23): drop any extension, probe
    the torchvision extension list."""
    parts = path.split(".")
    stem = ".".join(parts[:-1]) if len(parts) > 1 else path
    for ext in _IMG_EXTENSIONS:
        if os.path.isfile(stem + ext):
            return stem + ext
    return path if os.path.isfile(path) else None


class ImageDatabase:
    """Image loader keyed by annotation items. Returns HWC uint8 numpy
    arrays (RGB) instead of PIL/tensor objects; ``transform`` is any
    array→array callable (e.g. ops.image.clip_preprocess)."""

    def __init__(self, path: str,
                 annotation_db: Optional[AnnotationDatabase] = None,
                 transform=None, image_key: Optional[str] = None):
        self.base_path = path
        self.annotation_db = annotation_db
        self.transform = transform
        self.image_key = image_key

    def __len__(self) -> int:
        assert self.annotation_db is not None, "no annotation db attached"
        return len(self.annotation_db)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        assert self.annotation_db is not None, "no annotation db attached"
        return self.get(self.annotation_db[idx])

    def get(self, item: Dict[str, Any]) -> Dict[str, Any]:
        return self.from_path(self._get_attrs(item))

    def from_path(self, paths, use_transforms: bool = True
                  ) -> Dict[str, Any]:
        from PIL import Image

        if isinstance(paths, str):
            paths = [paths]
        images = []
        for name in paths:
            full = os.path.join(self.base_path, str(name))
            path = _possible_image_path(full)
            if not path:
                stem = ".".join(full.split(".")[:-1]) or full
                raise RuntimeError(
                    f"Image not found at path {stem}.{{jpeg|jpg|png}}.")
            with open(path, "rb") as f:
                arr = np.asarray(Image.open(f).convert("RGB"))
            if self.transform is not None and use_transforms:
                arr = self.transform(arr)
            images.append(arr)
        return {"images": images}

    def _get_attrs(self, item: Dict[str, Any]) -> List[str]:
        """image_database.py:166-193 incl. the NLVR2 identifier →
        (img0, img1) expansion."""
        if self.image_key:
            image = item[self.image_key]
            return [image] if isinstance(image, str) else list(image)
        image, pick = None, None
        for attr in _IMAGE_KEY_CANDIDATES:
            image = item.get(attr)
            if image is not None:
                pick = attr
                break
        if pick == "identifier" and "left_url" in item and (
                "right_url" in item):
            return [image + "-img0", image + "-img1"]
        return [str(image)]
