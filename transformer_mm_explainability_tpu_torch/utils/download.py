"""Checkpoint zoo with checksum verification, for the PyTorch port.

A copy of ``transformer_mm_explainability_tpu/utils/download.py`` (the
port imports nothing of the JAX package): the same five entries, URLs and
checks. The reference's DownloadableFile downloads and sha256-verifies the
published artifacts (mmf/utils/download.py:28-164; clip.load's
sha256-in-URL check, CLIP/clip/clip.py:75-103). ``resolve`` looks for a
LOCAL file first (the explicit path, then the cache) and downloads only
when asked to. Verification: a full ``sha256`` when the publisher states
one; otherwise the 8-hex-char prefix embedded in torch.hub-style filenames
(``*-<prefix8>.pth`` is the first 8 chars of the file's sha256, the
convention of torch.hub.load_state_dict_from_url, which both the timm ViT
and DETR release files follow). Entries with neither produce a LOUD
warning instead of silently skipping the check. The port's ``hub.py``
downloads nothing: it never calls ``resolve`` with ``allow_download=True``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import urllib.request
import warnings
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    name: str
    url: str
    sha256: Optional[str] = None
    loader: str = ""          # utils.clip_loader function name
    notes: str = ""


# the five published checkpoint families the reference depends on
# (SURVEY §5 "checkpoint conversion fidelity")
ZOO: Dict[str, ZooEntry] = {
    "clip_vit_b32": ZooEntry(
        "clip_vit_b32",
        "https://openaipublic.azureedge.net/clip/models/"
        "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/"
        "ViT-B-32.pt",
        sha256="40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
        loader="load_clip"),
    "vit_base_patch16_224": ZooEntry(
        "vit_base_patch16_224",
        "https://github.com/rwightman/pytorch-image-models/releases/"
        "download/v0.1-vitjx/jx_vit_base_p16_224-80ecf9dd.pth",
        loader="load_timm_vit"),
    "detr_r50": ZooEntry(
        "detr_r50",
        "https://dl.fbaipublicfiles.com/detr/detr-r50-e632da11.pth",
        loader="load_detr"),
    "lxmert_vqa": ZooEntry(
        "lxmert_vqa",
        "https://huggingface.co/unc-nlp/lxmert-vqa-uncased/resolve/main/"
        "pytorch_model.bin",
        loader="load_lxmert_hf"),
    "visual_bert_vqa2": ZooEntry(
        "visual_bert_vqa2",
        "https://dl.fbaipublicfiles.com/mmf/data/models/visual_bert/"
        "visual_bert.finetuned.vqa2.from_coco_train.tar.gz",
        loader="",
        notes="MMF tarball; utils.mmf_loader.load_visual_bert "
              "reads it"),
}


def _embedded_prefix(url: str) -> Optional[str]:
    """torch.hub filename convention: ``name-<sha256[:8]>.pth``."""
    m = re.search(r"-([0-9a-f]{8})\.pth$", os.path.basename(url))
    return m.group(1) if m else None


def verify(path: str, entry: "ZooEntry") -> None:
    """Raise on digest mismatch; warn loudly when no digest is known."""
    if entry.sha256:
        if sha256_of(path) != entry.sha256:
            raise IOError(
                f"{path} fails the sha256 check for {entry.name}")
        return
    prefix = _embedded_prefix(entry.url)
    if prefix:
        if not sha256_of(path).startswith(prefix):
            raise IOError(
                f"{path} fails the embedded sha256-prefix check "
                f"({prefix}) for {entry.name}")
        return
    warnings.warn(
        f"zoo entry {entry.name!r} has no published digest; loading "
        f"{path} WITHOUT integrity verification (torch.load unpickles "
        f"arbitrary code — only use files from trusted sources)",
        stacklevel=2)


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def resolve(name: str, cache_dir: str = "~/.cache/tmmx",
            local_path: Optional[str] = None,
            allow_download: bool = True) -> str:
    """Return a verified local path for a zoo entry.

    Order: explicit ``local_path`` → cache → download (when the
    environment has egress). Raises with a clear message otherwise.
    """
    entry = ZOO[name]
    cache_dir = os.path.expanduser(cache_dir)
    filename = os.path.basename(entry.url)
    candidates = [p for p in (local_path,
                              os.path.join(cache_dir, filename)) if p]
    for path in candidates:
        if os.path.exists(path):
            verify(path, entry)
            return path
    if not allow_download:
        raise FileNotFoundError(
            f"{name}: not found locally; place the file at "
            f"{os.path.join(cache_dir, filename)} (url: {entry.url})")
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, filename)
    try:
        urllib.request.urlretrieve(entry.url, target)
    except Exception as e:
        raise IOError(
            f"{name}: download failed ({e}); this environment may have "
            f"no egress — fetch {entry.url} elsewhere and pass "
            f"local_path") from e
    try:
        verify(target, entry)
    except IOError:
        os.remove(target)
        raise
    return target
