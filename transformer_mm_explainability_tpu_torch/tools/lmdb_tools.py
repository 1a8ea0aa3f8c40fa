"""npy feature-folder ↔ LMDB store conversion (C29 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/lmdb_tools.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/tools/scripts/features/lmdb_conversion.py``:
``convert`` packs a folder of per-image ``.npy`` feature files (with
optional ``*_info.npy`` sidecars) into one LMDB store whose record
schema matches what ``data/databases.LmdbFeatureReader`` (and MMF's
``LMDBFeatureReader``) read back: pickled dicts keyed by the relative
feature path, plus a pickled ``b"keys"`` index list.  ``extract``
unpacks a store back to the npy/_info.npy layout.

The ``lmdb`` package is optional, so the environment is
injectable (``lmdb_module=``) — tests drive the logic through an
in-memory fake; the CLI imports the real package.

Divergence pinned: the reference's ``extract`` writes
``image_height = item["image_width"]`` (lmdb_conversion.py:95 — a
copy-paste bug that corrupts every extracted info file); here height
comes from ``image_height``.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Any, Dict, List, Optional

#: reference lmdb_conversion.py:37 — 1 TiB address-space map
DEFAULT_MAP_SIZE = 1099511627776

INFO_FIELDS = ("image_height", "image_width", "num_boxes", "objects",
               "cls_prob", "bbox")


def _require_lmdb(lmdb_module):
    if lmdb_module is not None:
        return lmdb_module
    try:
        import lmdb
    except ImportError as e:  # pragma: no cover - exercised via fake
        raise ImportError(
            "lmdb store conversion needs the optional 'lmdb' package; "
            "the npy folder layout is readable directly by "
            "data/databases.FeatureReader without it") from e
    return lmdb


def convert_dir_to_lmdb(features_folder: str, lmdb_path: str,
                        lmdb_module=None,
                        map_size: int = DEFAULT_MAP_SIZE) -> List[bytes]:
    """lmdb_conversion.py:36-75: pack ``**/*.npy`` (minus ``_info.npy``
    sidecars) into an LMDB store.  Returns the key list that was also
    stored under ``b"keys"``."""
    lmdb = _require_lmdb(lmdb_module)
    env = lmdb.open(lmdb_path, map_size=map_size)
    id_list: List[bytes] = []
    features = sorted(
        f for f in glob.glob(
            os.path.join(features_folder, "**", "*.npy"), recursive=True)
        if not f.endswith("_info.npy"))

    import numpy as np

    with env.begin(write=True) as txn:
        for infile in features:
            split = os.path.relpath(infile, features_folder).split(".npy")[0]
            key = split.encode()
            item: Dict[str, Any] = {
                "feature_path": split,
                "features": np.load(infile, allow_pickle=True),
            }
            id_list.append(key)
            info_file = infile.split(".npy")[0] + "_info.npy"
            if os.path.isfile(info_file):
                info = np.load(info_file, allow_pickle=True).item()
                for field in INFO_FIELDS:
                    item[field] = info.get(field)
            txn.put(key, pickle.dumps(item))
        txn.put(b"keys", pickle.dumps(id_list))
    return id_list


def extract_lmdb_to_dir(lmdb_path: str, features_folder: str,
                        lmdb_module=None) -> List[str]:
    """lmdb_conversion.py:77-111: unpack a store back to
    ``<id>.npy`` + ``<id>_info.npy`` files.  Returns the image ids."""
    lmdb = _require_lmdb(lmdb_module)
    os.makedirs(features_folder, exist_ok=True)
    env = lmdb.open(lmdb_path, max_readers=1, readonly=True, lock=False,
                    readahead=False, meminit=False)

    import numpy as np

    ids: List[str] = []
    with env.begin(write=False) as txn:
        for key in pickle.loads(txn.get(b"keys")):
            item = pickle.loads(txn.get(key))
            img_id = key.decode("utf-8")
            ids.append(img_id)
            info = {"image_id": img_id}
            for field in INFO_FIELDS:
                info[field] = item.get(field)
            feat_path = os.path.join(features_folder, img_id + ".npy")
            # keys may carry subdirectories (convert globs **/*.npy)
            os.makedirs(os.path.dirname(feat_path), exist_ok=True)
            np.save(feat_path, item["features"])
            np.save(os.path.join(features_folder, img_id + "_info.npy"),
                    info)
    return ids


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", required=True,
                        choices=("convert", "extract"))
    parser.add_argument("--lmdb_path", required=True)
    parser.add_argument("--features_folder", required=True)
    args = parser.parse_args(argv)
    if args.mode == "convert":
        convert_dir_to_lmdb(args.features_folder, args.lmdb_path)
    else:
        extract_lmdb_to_dir(args.lmdb_path, args.features_folder)


if __name__ == "__main__":
    main()
