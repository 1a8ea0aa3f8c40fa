"""Native (C++) host components of the port, with ctypes bindings.

A private copy of ``transformer_mm_explainability_tpu/native/`` (importing
that package would load the JAX package):

  * ``phoc.cpp``       — the PHOC text descriptor (the reference's one
                         native op, cphoc.c, with a batch API)
  * ``tsv_reader.cpp`` — the streaming base64-TSV object-feature parser
                         (the LXMERT data loader's hot path) and the
                         prefetching batch loader

This is host code, not a CUDA kernel. It is compiled at first use, as the
JAX loader compiles it, into ``build/native/`` at the root of the checkout
(a directory git ignores), never beside its sources:

    g++ -O3 -shared -fPIC -std=c++17 -pthread \\
        -o build/native/libtmmx_native-<hash>.so phoc.cpp tsv_reader.cpp

The hash covers both sources and the flags, so an edited source is
rebuilt and a stale library is never loaded. Processes that build at once
(the test suite runs in several) take a file lock, and the one that
compiles writes a temporary file in the same directory and renames it into
place: no process loads half a library.

Departures from the JAX loader, each so that the native and the Python
readers of ``data/vqa.load_obj_tsv`` give the same records:
``tsv.load_obj_tsv`` also returns ``attrs_id`` and ``attrs_conf``, and
sizes each record by its own box count (the JAX reader cuts records at 100
boxes). Nothing falls back: where the library cannot be built, the call
raises. ``phoc_py`` is the pure-Python PHOC, the tests' oracle.

The stores and loaders live in process-global tables of the library that
no lock guards (as in the JAX library): open, read and close them from one
thread at a time. A ``BatchLoader``'s own threads are the library's.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = ("phoc.cpp", "tsv_reader.cpp")
BUILD_DIR = _DIR.parents[1] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """Path of the C++ compiler; raises where there is none."""
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found on PATH: the native library "
                           f"({', '.join(SOURCES)}) cannot be built")
    return found


def library_path(build_dir=None) -> pathlib.Path:
    """Where the library is built to (hash of the sources and the flags)."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (_DIR / name).read_bytes())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    return pathlib.Path(build_dir or BUILD_DIR) / \
        f"libtmmx_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False, build_dir=None) -> str:
    """Compile the native library unless it is built already (``force``:
    compile it again all the same, under the same lock); returns its path.
    Safe to call from several processes at once."""
    out = library_path(build_dir)
    if out.exists() and not force:
        return str(out)
    cxx = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as held:
        fcntl.flock(held, fcntl.LOCK_EX)   # released when the file closes
        if force or not out.exists():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp),
                 *(str(_DIR / name) for name in SOURCES)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{CXX} failed (exit {proc.returncode}) "
                                   f"building the native library:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
    return str(out)


def lib() -> ctypes.CDLL:
    """The built and loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(build()))
        return _lib


def _declare(L: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, c_int = ctypes.c_int64, ctypes.c_int32, ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    L.phoc_build.argtypes = [ctypes.c_char_p, f32p]
    L.phoc_build.restype = c_int
    L.phoc_build_batch.argtypes = [ctypes.c_char_p, c_int, f32p]
    L.phoc_build_batch.restype = c_int
    L.phoc_dim.restype = c_int
    L.tsv_open.argtypes = [ctypes.c_char_p, i64]
    L.tsv_open.restype = i64
    L.tsv_open_mt.argtypes = [ctypes.c_char_p, i64, c_int]
    L.tsv_open_mt.restype = i64
    L.tsv_count.argtypes = [i64]
    L.tsv_count.restype = i64
    L.tsv_feat_dim.argtypes = [i64]
    L.tsv_feat_dim.restype = c_int
    L.tsv_num_boxes.argtypes = [i64, i64]
    L.tsv_num_boxes.restype = c_int
    L.tsv_get.argtypes = [
        i64, i64, ctypes.c_char_p, c_int, ctypes.POINTER(c_int),
        ctypes.POINTER(c_int), f32p, f32p, i64p, f32p, c_int]
    L.tsv_get.restype = c_int
    L.tsv_get_attrs.argtypes = [i64, i64, i64p, f32p, c_int]
    L.tsv_get_attrs.restype = c_int
    L.tsv_close.argtypes = [i64]
    L.loader_create.argtypes = [i64, i64p, i64, c_int, c_int, c_int, c_int,
                                c_int]
    L.loader_create.restype = i64
    L.loader_next.argtypes = [i64, f32p, f32p, ctypes.POINTER(i32)]
    L.loader_next.restype = c_int
    L.loader_num_batches.argtypes = [i64]
    L.loader_num_batches.restype = i64
    L.loader_destroy.argtypes = [i64]
    return L


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# --------------------------------------------------------------------------
# PHOC
# --------------------------------------------------------------------------

PHOC_DIM = 604


def build_phoc(word: str) -> np.ndarray:
    """604-dim PHOC vector (build_phoc.py equivalent, native path)."""
    out = np.zeros(PHOC_DIM, np.float32)
    if lib().phoc_build(word.encode(), _f32(out)) != 0:
        raise ValueError(f"unknown character in word {word!r}")
    return out


def build_phoc_batch(words: List[str]) -> np.ndarray:
    """``[len(words), 604]`` PHOC vectors in one native call."""
    out = np.zeros((len(words), PHOC_DIM), np.float32)
    blob = b"\0".join(w.encode() for w in words) + b"\0"
    bad = lib().phoc_build_batch(blob, len(words), _f32(out))
    if bad >= 0:
        raise ValueError(f"unknown character in word {words[bad]!r}")
    return out


def phoc_py(word: str) -> np.ndarray:
    """Pure-Python PHOC (the test oracle). Arithmetic in float32 to match
    the C implementations' ≥ 0.5 boundary behaviour (cphoc.c uses float;
    e.g. the middle character of a 3-letter word lands exactly on the 0.5
    overlap boundary and rounds differently in float64)."""
    f32 = np.float32
    unigrams = "abcdefghijklmnopqrstuvwxyz0123456789"
    bigrams = ["th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
               "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
               "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
               "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
               "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el"]
    out = np.zeros(PHOC_DIM, np.float32)
    n = len(word)
    if n == 0:
        return out
    for i, ch in enumerate(word):
        ci = unigrams.index(ch)
        c0, c1 = f32(i) / f32(n), f32(i + 1) / f32(n)
        base = 0
        for level in range(2, 6):
            for region in range(level):
                lo = max(c0, f32(region) / f32(level))
                hi = min(c1, f32(region + 1) / f32(level))
                if f32(f32(hi - lo) / f32(c1 - c0)) >= f32(0.5):
                    out[(base + region) * 36 + ci] = 1.0
            base += level
    off = 14 * 36
    for i in range(n - 1):
        bg = word[i:i + 2]
        if bg not in bigrams:
            continue
        bi = bigrams.index(bg)
        b0, b1 = f32(i) / f32(n), f32(i + 2) / f32(n)
        for region in range(2):
            lo = max(b0, f32(region) / f32(2))
            hi = min(b1, f32(region + 1) / f32(2))
            if f32(f32(hi - lo) / f32(b1 - b0)) >= f32(0.5):
                out[off + region * 50 + bi] = 1.0
    return out


# --------------------------------------------------------------------------
# TSV
# --------------------------------------------------------------------------

class tsv:
    """Namespace for the native TSV reader (see data/vqa.load_obj_tsv)."""

    @staticmethod
    def load_obj_tsv(path: str, topk: Optional[int] = None):
        """Every valid row of the file (the first ``topk``), as the dicts
        ``data/vqa.load_obj_tsv`` parses in Python, in its key order."""
        L = lib()
        # parallel parse where cores are available; tsv_open_mt(n <= 1) is
        # the sequential parser, which a small topk over a huge file prefers
        # (it stops early)
        n_threads = 1 if topk is not None else min(os.cpu_count() or 1, 8)
        h = L.tsv_open_mt(str(path).encode(), -1 if topk is None else topk,
                          n_threads)
        if h < 0:
            raise IOError(f"cannot open {path}")
        try:
            feat_dim = max(L.tsv_feat_dim(h), 1)
            out = []
            for i in range(L.tsv_count(h)):
                m = L.tsv_num_boxes(h, i)
                img_id = ctypes.create_string_buffer(256)
                ih, iw = ctypes.c_int(), ctypes.c_int()
                boxes = np.zeros((m, 4), np.float32)
                feats = np.zeros((m, feat_dim), np.float32)
                oid = np.zeros(m, np.int64)
                oconf = np.zeros(m, np.float32)
                aid = np.zeros(m, np.int64)
                aconf = np.zeros(m, np.float32)
                n = L.tsv_get(h, i, img_id, 256, ctypes.byref(ih),
                              ctypes.byref(iw), _f32(boxes), _f32(feats),
                              _i64(oid), _f32(oconf), m)
                L.tsv_get_attrs(h, i, _i64(aid), _f32(aconf), m)
                out.append({
                    "img_id": img_id.value.decode(),
                    "img_h": ih.value, "img_w": iw.value,
                    "objects_id": oid, "objects_conf": oconf,
                    "attrs_id": aid, "attrs_conf": aconf,
                    "num_boxes": n, "boxes": boxes, "features": feats,
                })
            return out
        finally:
            L.tsv_close(h)


# --------------------------------------------------------------------------
# Prefetching batch loader (the torch-DataLoader-worker equivalent)
# --------------------------------------------------------------------------

class TsvStore:
    """Keeps a native TSV store open (unlike ``tsv.load_obj_tsv``, which
    copies everything into Python dicts and closes). The parse is
    multithreaded (``tsv_open_mt``)."""

    def __init__(self, path: str, topk: Optional[int] = None,
                 n_threads: int = 0):
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 2, 8)
        L = lib()
        self._L = L
        self.handle = L.tsv_open_mt(
            str(path).encode(), -1 if topk is None else topk, n_threads)
        if self.handle < 0:
            raise IOError(f"cannot open {path}")
        self.count = L.tsv_count(self.handle)
        self.feat_dim = L.tsv_feat_dim(self.handle)

    def close(self):
        if self.handle >= 0:
            self._L.tsv_close(self.handle)
            self.handle = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class BatchLoader:
    """Background-threaded batch assembly over an open ``TsvStore``:
    model-ready padded numpy ``{features [B, M, D], boxes [B, M, 4]
    (LXMERT-normalised), num_boxes [B], valid k}`` batches prefetched
    ``depth`` deep, so that host assembly overlaps device compute."""

    def __init__(self, store: TsvStore, order, batch: int,
                 max_boxes: int = 36, depth: int = 3, n_threads: int = 2,
                 normalize: bool = True):
        self.store = store
        self.batch = batch
        self.max_boxes = max_boxes
        order = np.ascontiguousarray(np.asarray(order, np.int64))
        self.handle = lib().loader_create(
            store.handle, _i64(order), len(order), batch, max_boxes, depth,
            n_threads, 1 if normalize else 0)
        if self.handle < 0:
            raise ValueError("loader_create failed (bad store/order)")
        self.num_batches = lib().loader_num_batches(self.handle)

    def __iter__(self):
        D = self.store.feat_dim
        while True:
            feats = np.empty((self.batch, self.max_boxes, D), np.float32)
            boxes = np.empty((self.batch, self.max_boxes, 4), np.float32)
            nbox = np.empty((self.batch,), np.int32)
            k = lib().loader_next(
                self.handle, _f32(feats), _f32(boxes),
                nbox.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if k < 0:
                raise RuntimeError("loader_next on a destroyed loader")
            if k == 0:
                return
            yield {"features": feats, "boxes": boxes,
                   "num_boxes": nbox, "k": int(k)}

    def close(self):
        if self.handle >= 0:
            lib().loader_destroy(self.handle)
            self.handle = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
