"""Hateful Memes challenge-zip converter (C29/C34 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/hm_convert.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/mmf_cli/hm_convert.py``: verify the
DrivenData zip against the published sha256 set, extract it (unzip CLI
first — python's zipfile is slow on encrypted archives — with a
zipfile fallback), detect Phase 1 vs Phase 2 by which jsonl files are
present, and lay the files out in the MMF cache structure
(``datasets/hateful_memes/defaults/{images,annotations}``) the
hateful-memes builders read.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import tarfile
import warnings
import zipfile
from typing import List, Optional

# hm_convert.py:16-30
IMAGE_FILES = ["img.tar.gz", "img"]
JSONL_PHASE_ONE_FILES = ["train.jsonl", "dev.jsonl", "test.jsonl"]
JSONL_PHASE_TWO_FILES = ["train.jsonl", "dev_seen.jsonl", "test_seen.jsonl",
                         "dev_unseen.jsonl", "test_unseen.jsonl"]
POSSIBLE_CHECKSUMS = [
    "d8f1073f5fbf1b08a541cc2325fc8645619ab8ed768091fb1317d5c3a6653a77",
    "a424c003b7d4ea3f3b089168b5f5ea73b90a3ff043df4b8ff4d7ed87c51cb572",
    "6e609b8c230faff02426cf462f0c9528957b7884d68c60ebc26ff83846e5f80f",
    "c1363aae9649c79ae4abfdb151b56d3d170187db77757f3daa80856558ac367c",
]


def checksum(path: str, hashes: List[str]) -> None:
    """hm_convert.py:169-184: sha256 over 64 KiB blocks; AssertionError
    on mismatch."""
    sha256_hash = hashlib.sha256()
    with open(path, "rb") as f:
        for byte_block in iter(lambda: f.read(65536), b""):
            sha256_hash.update(byte_block)
    if sha256_hash.hexdigest() not in hashes:
        raise AssertionError(
            "Checksum of downloaded file does not match the expected "
            "checksum. Please try again.")


def decompress_zip(dest: str, fname: str,
                   password: Optional[str] = None) -> None:
    """hm_convert.py:186-202: unzip CLI first, zipfile fallback."""
    path = os.path.join(dest, fname)
    try:
        command = ["unzip", "-o", "-q", "-d", dest]
        if password:
            command += ["-P", password]
        command += [path]
        subprocess.run(command, check=True)
    except Exception:
        with zipfile.ZipFile(path, "r") as obj:
            if password:
                obj.setpassword(password.encode("utf-8"))
            obj.extractall(path=dest)


def assert_files(folder: str) -> bool:
    """hm_convert.py:37-70: True for Phase 1 layout, False (with a
    warning) for Phase 2; AssertionError when neither img nor
    img.tar.gz is present."""
    phase_one = all(
        os.path.exists(os.path.join(folder, "data", f))
        for f in JSONL_PHASE_ONE_FILES)
    if not phase_one:
        for f in JSONL_PHASE_TWO_FILES:
            assert os.path.exists(os.path.join(folder, "data", f)), \
                f"{f} doesn't exist in {folder}"
    else:
        warnings.warn("You are on Phase 1 of the Hateful Memes "
                      "Challenge. Please update to Phase 2")
    if not any(os.path.exists(os.path.join(folder, "data", f))
               for f in IMAGE_FILES):
        raise AssertionError(
            "Neither img or img.tar.gz exists in current zip")
    return phase_one


def convert(zip_file: str, data_dir: str, password: Optional[str] = None,
            move_dir: bool = False, bypass_checksum: bool = False) -> str:
    """hm_convert.py:98-167: the full conversion.  Returns the dataset
    base path."""
    base_path = os.path.join(data_dir, "datasets", "hateful_memes",
                             "defaults")
    images_path = os.path.join(base_path, "images")
    os.makedirs(images_path, exist_ok=True)

    if not bypass_checksum:
        checksum(zip_file, POSSIBLE_CHECKSUMS)

    dest_zip = os.path.join(images_path, os.path.basename(zip_file))
    if move_dir:
        shutil.move(zip_file, dest_zip)
    else:
        shutil.copy(zip_file, dest_zip)

    decompress_zip(images_path, os.path.basename(zip_file),
                   password=password)

    phase_one = assert_files(images_path)

    annotations_path = os.path.join(base_path, "annotations")
    os.makedirs(annotations_path, exist_ok=True)
    annotations = (JSONL_PHASE_ONE_FILES if phase_one
                   else JSONL_PHASE_TWO_FILES)
    for annotation in annotations:
        shutil.move(os.path.join(images_path, "data", annotation),
                    os.path.join(annotations_path, annotation))

    for image_file in IMAGE_FILES:
        src = os.path.join(images_path, "data", image_file)
        if not os.path.exists(src):
            continue
        dest = os.path.join(images_path, image_file)
        shutil.move(src, dest)
        if src.endswith(".tar.gz"):
            with tarfile.open(dest) as tar:
                try:
                    tar.extractall(path=images_path, filter="data")
                except TypeError:  # filter= needs >= 3.10.12/3.11.4
                    tar.extractall(path=images_path)
    return base_path


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--zip_file", required=True, type=str,
                        help="Zip file downloaded from the DrivenData")
    parser.add_argument("--password", required=True, type=str,
                        help="Password for the zip file")
    parser.add_argument("--move", required=False, type=int,
                        help="Move data dir to mmf cache dir")
    parser.add_argument("--mmf_data_folder", required=True, type=str,
                        help="MMF Data folder")
    parser.add_argument("--bypass_checksum", required=False, type=int,
                        help="Pass 1 if you want to skip checksum")
    args = parser.parse_args(argv)
    convert(args.zip_file, args.mmf_data_folder,
            password=args.password, move_dir=bool(args.move),
            bypass_checksum=bool(args.bypass_checksum))


if __name__ == "__main__":
    main()
