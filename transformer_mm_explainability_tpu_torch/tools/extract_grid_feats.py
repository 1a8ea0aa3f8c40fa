"""ResNet-152 pool5 grid-feature extraction, on the PyTorch port.

Counterpart of ``transformer_mm_explainability_tpu/tools/extract_grid_feats.py``
(a re-design of
``VisualBERT/tools/scripts/features/extract_resnet152_feat.py``): run the
ResNet trunk (``models/resnet``: through layer4, no avgpool/fc, the same
``children()[:-2]`` cut the reference takes) over an image folder and save
one ``[1, H/32, W/32, 2048]`` NHWC ``.npy`` per image (the reference
permutes NCHW→NHWC before saving, :112).

Protocol knobs match the reference: 448×448 resize, ImageNet mean/std
normalisation, ``image_id % total_group == group_id`` sharding for
multi-worker runs (:99), ``.lock`` directories marking in-flight writes (a
finished ``.npy`` with no lock is skipped on re-runs, while one left with a
stale lock by a crashed worker is regenerated, :105-119) and grey-scale
expansion to 3 channels (:55-57).

Images are batched on the host and the trunk runs once per batch. The
convolutions are cuDNN's, in fp32 with TF32 off (``resolve_device``): the
JAX package computes them outside any Pallas kernel, so no kernel of the
port runs here.

    python -m transformer_mm_explainability_tpu_torch.tools.extract_grid_feats \\
        --data_dir DIR --out_dir DIR [--total_group 1 --group_id 0] \\
        [--image_ext jpg] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import resnet

TARGET_IMAGE_SIZE = (448, 448)
CHANNEL_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
CHANNEL_STD = np.array([0.229, 0.224, 0.225], np.float32)
RESNET152_STAGES = (3, 8, 36, 3)


def preprocess_image(img: np.ndarray) -> np.ndarray:
    """extract_resnet152_feat.py:19-25 + 52-57: resize to 448×448 (PIL
    bilinear), scale to [0,1], normalise; HWC float32 out. Grey-scale
    inputs are expanded to 3 channels."""
    from PIL import Image

    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    pil = Image.fromarray(img.astype(np.uint8))
    pil = pil.resize(TARGET_IMAGE_SIZE[::-1], Image.BILINEAR)
    x = np.asarray(pil, np.float32) / 255.0
    return (x - CHANNEL_MEAN) / CHANNEL_STD


def get_image_id(image_name: str) -> int:
    """extract_resnet152_feat.py:66-68: trailing _<id> of the stem."""
    return int(image_name.split(".")[0].split("_")[-1])


def make_trunk(stages: Sequence[int] = RESNET152_STAGES, seed: int = 0,
               params: Optional[Dict] = None, device="cuda"):
    """NHWC ResNet trunk on ``device``: a host batch ``[B, H, W, 3]`` →
    numpy ``[B, H/32, W/32, 2048]`` features.

    ``stages`` defaults to ResNet-152 (3, 8, 36, 3); tests pass a tiny
    stage tuple. ``params`` may come from
    ``utils/convert.resnet_from_state_dict`` for published weights; else
    they are drawn from ``seed``."""
    device = resolve_device(device)
    if params is None:
        params = resnet.init_params(seed, stages=tuple(stages),
                                    device=device)

    def run(batch_hwc: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(batch_hwc, np.float32))
        with torch.no_grad():
            return resnet.forward(params, x.to(device)).cpu().numpy()

    return run


def extract_dataset_pool5(image_dir: str, save_dir: str,
                          total_group: int = 1, group_id: int = 0,
                          ext_filter: str = "jpg",
                          exclude: Sequence[str] = (),
                          trunk=None, batch_size: int = 8) -> List[str]:
    """extract_resnet152_feat.py:70-120: the extraction loop. Returns the
    list of written feature paths."""
    from PIL import Image

    trunk = trunk or make_trunk()
    os.makedirs(save_dir, exist_ok=True)
    excluded = {e: 1 for e in exclude}
    # a .npy only counts as done when no stale .lock sits next to it: a
    # crashed worker leaves both, and its (possibly truncated) file must be
    # regenerated (the reference's done-set at :78-83 ignores locks, making
    # its own redo check at :105 unreachable; pinned)
    done = {os.path.basename(f)[:-len(".npy")]: 1
            for f in glob(os.path.join(save_dir, "*.npy"))
            if not os.path.exists(f + ".lock")}

    todo: List[Tuple[str, str]] = []
    for impath in sorted(glob(os.path.join(image_dir, "*." + ext_filter))):
        image_name = os.path.basename(impath)
        stem = os.path.splitext(image_name)[0]
        if stem in excluded or stem in done:
            continue
        if get_image_id(image_name) % total_group != group_id:
            continue
        save_path = os.path.join(save_dir, stem + ".npy")
        if (os.path.exists(save_path)
                and not os.path.exists(save_path + ".lock")):
            continue
        todo.append((impath, save_path))

    written: List[str] = []
    for i in range(0, len(todo), batch_size):
        chunk = todo[i:i + batch_size]
        locks = []
        batch, keep = [], []
        for impath, save_path in chunk:
            tmp_lock = save_path + ".lock"
            if not os.path.exists(tmp_lock):
                os.makedirs(tmp_lock)
            locks.append(tmp_lock)
            try:
                img = np.asarray(Image.open(impath).convert("RGB"))
                batch.append(preprocess_image(img))
                keep.append(save_path)
            except Exception:
                print("error for " + os.path.basename(impath))
        if batch:
            feats = trunk(np.stack(batch))  # [b, h, w, 2048]
            for j, save_path in enumerate(keep):
                np.save(save_path, feats[j:j + 1])
                written.append(save_path)
        for tmp_lock in locks:
            if os.path.isdir(tmp_lock):
                os.rmdir(tmp_lock)
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--total_group", type=int, default=1)
    parser.add_argument("--group_id", type=int, default=0)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--image_ext", type=str, default="jpg")
    parser.add_argument("--seed", type=int, default=0,
                        help="the random ResNet-152's seed")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    trunk = make_trunk(seed=args.seed, device=args.device)
    written = extract_dataset_pool5(args.data_dir, args.out_dir,
                                    args.total_group, args.group_id,
                                    args.image_ext, trunk=trunk)
    print(f"wrote {len(written)} feature files to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
