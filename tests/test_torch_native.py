"""The port's ``native/`` library (PHOC, the TSV reader, the batch loader)
against the JAX package's and against the Python readers, exactly; its
build (into ``build/native/``, under a file lock, by several processes at
once); and ``data/vqa.load_obj_tsv``'s native branch, which raises rather
than falling back to Python."""

import base64
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from _jax_native import private_jax_native
from transformer_mm_explainability_tpu.data import vqa as jvqa
from transformer_mm_explainability_tpu_torch import native
from transformer_mm_explainability_tpu_torch.data import vqa as tvqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["the", "a", "question", "42", "th", "lllllll", "x0x0x0", "",
         "stop", "heathen", "abcdefghijklmnopqrstuvwxyz0123456789"]
# the keys the JAX reader's records carry (it does not read attributes)
JAX_KEYS = ("img_id", "img_h", "img_w", "num_boxes", "boxes", "features",
            "objects_id", "objects_conf")


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    with private_jax_native(tmp_path_factory.mktemp("jax_native")) as mod:
        yield mod


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _row(img_id, n, dim, rng, h=480, w=640, n_feat_rows=None, n_box_rows=None):
    """One TSV row with distinct object and attribute payloads; the payload
    row counts can be cut to make malformed rows."""
    return "\t".join([
        img_id, str(h), str(w),
        _b64(rng.randint(0, 1600, n).astype(np.int64)),
        _b64(rng.rand(n).astype(np.float32)),
        _b64(rng.randint(0, 400, n).astype(np.int64)),
        _b64(rng.rand(n).astype(np.float32)),
        str(n),
        _b64((rng.rand(n if n_box_rows is None else n_box_rows, 4) * 600
              ).astype(np.float32)),
        _b64(rng.randn(n if n_feat_rows is None else n_feat_rows,
                       dim).astype(np.float32)),
    ])


def _write(path, rows):
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _good_file(path, n_images=5, n_boxes=7, dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return _write(path, [_row(f"img_{i}", n_boxes + i % 3, dim, rng)
                         for i in range(n_images)])


def _same_records(got, want, keys):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in keys:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert type(a[k]) is type(b[k]) and a[k] == b[k], k


# ---------------------------------------------------------------- PHOC
@pytest.mark.parametrize("word", WORDS)
def test_phoc_matches_jax_and_python(jnative, word):
    got = native.build_phoc(word)
    assert got.dtype == np.float32 and got.shape == (604,)
    np.testing.assert_array_equal(got, jnative.build_phoc(word))
    np.testing.assert_array_equal(got, native.phoc_py(word))
    np.testing.assert_array_equal(native.phoc_py(word), jnative.phoc_py(word))


def test_phoc_batch_and_unknown_characters(jnative):
    batch = native.build_phoc_batch(WORDS)
    np.testing.assert_array_equal(batch, jnative.build_phoc_batch(WORDS))
    for i, w in enumerate(WORDS):
        np.testing.assert_array_equal(batch[i], native.build_phoc(w))
    with pytest.raises(ValueError, match="héllo"):
        native.build_phoc("héllo")
    with pytest.raises(ValueError, match="Stop"):
        native.build_phoc_batch(["stop", "Stop"])
    assert native.lib().phoc_dim() == native.PHOC_DIM == 604


# ----------------------------------------------------------------- TSV
def test_tsv_native_equals_python_and_jax(jnative, tmp_path):
    """The port's native records equal its Python parse bit for bit, every
    key (attributes too); the JAX readers give the same records."""
    p = _good_file(tmp_path / "feats.tsv")
    nat = tvqa.load_obj_tsv(p)
    py = tvqa.load_obj_tsv(p, use_native=False)
    assert list(nat[0]) == list(py[0])        # the same keys, in order
    _same_records(nat, py, list(py[0]))
    _same_records(py, jvqa.load_obj_tsv(p, use_native=False), list(py[0]))
    _same_records(nat, jnative.tsv.load_obj_tsv(p), JAX_KEYS)
    assert [r["num_boxes"] for r in nat] == [7, 8, 9, 7, 8]
    # FeatureStore pads the same records to the same arrays
    a, b = tvqa.FeatureStore(nat, 12), tvqa.FeatureStore(py, 12)
    for img_id in ("img_0", "img_4"):
        for k, v in b[img_id].items():
            np.testing.assert_array_equal(a[img_id][k], v, err_msg=k)


def _malformed(path):
    """Two good rows, then a truncated feature payload, a feature dim that
    differs from the store's, truncated boxes and zero boxes (JAX
    ``tests/test_native.py``'s cases)."""
    rng = np.random.RandomState(7)
    return _write(path, [
        _row("img_0", 5, 16, rng), _row("img_1", 5, 16, rng),
        _row("img_trunc", 5, 16, rng, n_feat_rows=2),
        _row("img_dim", 5, 8, rng),
        _row("img_box", 5, 16, rng, n_box_rows=3),
        _row("img_zero", 0, 16, rng)])


def _poisoned(path):
    """A corrupt first row whose payload divides its box count (dim 8),
    then three genuine dim-16 rows: the majority dim wins."""
    rng = np.random.RandomState(8)
    return _write(path, [_row("bad", 4, 8, rng)]
                  + [_row(f"img{i}", 4, 16, rng) for i in range(3)])


def _prefix(path):
    """A short corrupt prefix (3 rows) before 80 genuine ones: with topk
    the slack window keeps the prefix from winning the vote."""
    rng = np.random.RandomState(9)
    return _write(path, [_row(f"bad{i}", 4, 8, rng) for i in range(3)]
                  + [_row(f"img{i}", 4, 16, rng) for i in range(80)])


@pytest.mark.parametrize("case,topk,ids", [
    ("malformed", None, ["img_0", "img_1"]),
    ("poisoned", None, ["img0", "img1", "img2"]),
    ("prefix", 2, ["img0", "img1"]),
    ("good", 2, ["img_0", "img_1"]),
])
def test_tsv_validation_matches_jax(jnative, tmp_path, case, topk, ids):
    maker = {"malformed": _malformed, "poisoned": _poisoned,
             "prefix": _prefix, "good": _good_file}[case]
    p = maker(tmp_path / f"{case}.tsv")
    got = native.tsv.load_obj_tsv(p, topk=topk)
    assert [r["img_id"] for r in got] == ids
    assert all(r["features"].shape == (r["num_boxes"], 16) for r in got)
    _same_records(got, jnative.tsv.load_obj_tsv(p, topk=topk), JAX_KEYS)


def test_tsv_keeps_every_box(jnative, tmp_path):
    """A record of 120 boxes stays whole (the JAX reader cuts it at 100)."""
    p = _write(tmp_path / "many.tsv",
               [_row("big", 120, 4, np.random.RandomState(3))])
    (got,) = tvqa.load_obj_tsv(p)
    (py,) = tvqa.load_obj_tsv(p, use_native=False)
    _same_records([got], [py], list(py))
    (theirs,) = jnative.tsv.load_obj_tsv(p)
    assert got["num_boxes"] == 120 and theirs["num_boxes"] == 100
    np.testing.assert_array_equal(got["features"][:100], theirs["features"])


def test_tsv_open_mt_matches_sequential(tmp_path):
    p = _good_file(tmp_path / "mt.tsv", n_images=17, n_boxes=6, dim=12,
                   seed=4).encode()
    L = native.lib()
    for topk in (-1, 5):
        h_seq, h_mt = L.tsv_open(p, topk), L.tsv_open_mt(p, topk, 4)
        assert L.tsv_count(h_seq) == L.tsv_count(h_mt) == \
            (17 if topk < 0 else 5)
        assert L.tsv_feat_dim(h_seq) == L.tsv_feat_dim(h_mt) == 12
        for i in range(L.tsv_count(h_seq)):
            rows = []
            for h in (h_seq, h_mt):
                m = L.tsv_num_boxes(h, i)
                img_id = ctypes.create_string_buffer(64)
                ih, iw = ctypes.c_int(), ctypes.c_int()
                boxes = np.zeros((m, 4), np.float32)
                feats = np.zeros((m, 12), np.float32)
                oid, aid = np.zeros(m, np.int64), np.zeros(m, np.int64)
                oconf, aconf = np.zeros(m, np.float32), np.zeros(m, np.float32)
                n = L.tsv_get(h, i, img_id, 64, ctypes.byref(ih),
                              ctypes.byref(iw), native._f32(boxes),
                              native._f32(feats), native._i64(oid),
                              native._f32(oconf), m)
                assert L.tsv_get_attrs(h, i, native._i64(aid),
                                       native._f32(aconf), m) == n == m
                rows.append((img_id.value, n, boxes, feats, oid, aid, aconf))
            assert rows[0][:2] == rows[1][:2]
            for a, b in zip(rows[0][2:], rows[1][2:]):
                np.testing.assert_array_equal(a, b)
        assert L.tsv_num_boxes(h_seq, 99) == -1
        L.tsv_close(h_seq)
        L.tsv_close(h_mt)


# ---------------------------------------------------------- BatchLoader
def test_batch_loader_matches_manual_padding_and_jax(jnative, tmp_path):
    """Batches equal manual per-sample padding with LXMERT box
    normalisation, in the given (shuffled) order, the tail batch short;
    and the JAX loader's batches."""
    p = _good_file(tmp_path / "load.tsv", n_images=11, n_boxes=5, dim=12,
                   seed=5)
    recs = tvqa.load_obj_tsv(p, use_native=False)
    order = np.random.RandomState(0).permutation(11)
    store = native.TsvStore(p, n_threads=3)
    assert store.count == 11 and store.feat_dim == 12
    loader = native.BatchLoader(store, order, batch=4, max_boxes=7,
                                depth=2, n_threads=2)
    jstore = jnative.TsvStore(p, n_threads=3)
    jloader = jnative.BatchLoader(jstore, order, batch=4, max_boxes=7,
                                  depth=2, n_threads=2)
    assert loader.num_batches == 3
    got, want = list(loader), list(jloader)
    assert [b["k"] for b in got] == [4, 4, 3]
    flat = 0
    for b, jb in zip(got, want):
        assert b["k"] == jb["k"]
        for s in range(b["k"]):
            r = recs[order[flat]]
            n = r["num_boxes"]
            assert b["num_boxes"][s] == n
            np.testing.assert_array_equal(b["features"][s, :n], r["features"])
            np.testing.assert_array_equal(b["features"][s, n:], 0)
            want_boxes = r["boxes"].copy()
            want_boxes[:, (0, 2)] /= 640.0
            want_boxes[:, (1, 3)] /= 480.0
            np.testing.assert_allclose(b["boxes"][s, :n], want_boxes,
                                       rtol=1e-6)
            for k in ("features", "boxes", "num_boxes"):
                np.testing.assert_array_equal(b[k][s], jb[k][s])
            flat += 1
    assert list(loader) == []       # exhausted
    for x in (loader, store, jloader, jstore):
        x.close()


def test_batch_loader_unnormalized_and_errors(tmp_path):
    p = _good_file(tmp_path / "raw.tsv", n_images=3, n_boxes=4, dim=8,
                   seed=6)
    recs = tvqa.load_obj_tsv(p, use_native=False)
    store = native.TsvStore(p)
    loader = native.BatchLoader(store, [0, 1, 2], batch=2, max_boxes=6,
                                normalize=False)
    b = next(iter(loader))
    np.testing.assert_array_equal(b["boxes"][0, :4], recs[0]["boxes"])
    loader.close()
    with pytest.raises(ValueError):
        native.BatchLoader(store, [0, 99], batch=2)
    store.close()
    with pytest.raises(IOError):
        native.TsvStore(str(tmp_path / "missing.tsv"))


# ---------------------------------------------------------------- build
def test_builds_into_build_native_by_hash():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libtmmx_native-") and path.suffix == ".so"
    native.lib()
    assert path.exists()
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


def test_native_branch_raises_without_a_compiler(tmp_path, monkeypatch):
    """No compiler, no built library: ``use_native=True`` raises and does
    not fall back to Python; ``use_native=False`` still parses."""
    p = _good_file(tmp_path / "f.tsv", n_images=2)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "tmmx-no-such-compiler")
    with pytest.raises(RuntimeError, match="tmmx-no-such-compiler"):
        tvqa.load_obj_tsv(p)
    with pytest.raises(RuntimeError):
        native.build_phoc("stop")
    assert len(tvqa.load_obj_tsv(p, use_native=False)) == 2
    assert not (tmp_path / "empty").exists()


def test_concurrent_builds_load_one_library(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, the same file, and no temporary file is left."""
    code = ("import ctypes, sys\n"
            "from transformer_mm_explainability_tpu_torch import native\n"
            "p = native.build(build_dir=sys.argv[1])\n"
            "print(ctypes.CDLL(p).phoc_dim(), p)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range(4)]
    outs = [proc.communicate(timeout=240) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), outs
    lines = {out.strip() for out, _ in outs}
    want = native.library_path(tmp_path)
    assert lines == {f"604 {want}"}, lines
    assert sorted(os.listdir(tmp_path)) == [".build.lock", want.name]


def test_build_force_rebuilds_under_the_lock(jnative, tmp_path,
                                            monkeypatch):
    """``build(force=True)``, the JAX ``build(force=True)``: it compiles
    again where the library is built already (a new file renamed into
    place, no temporary left), where ``build()`` returns the one there;
    the rebuilt library's PHOC equals the JAX library's."""
    first = native.build(build_dir=tmp_path)
    inode = os.stat(first).st_ino
    assert native.build(build_dir=tmp_path) == first
    assert os.stat(first).st_ino == inode
    again = native.build(force=True, build_dir=tmp_path)
    assert again == first and os.stat(again).st_ino != inode
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    for word in WORDS[:4]:
        np.testing.assert_array_equal(native.build_phoc(word),
                                      jnative.build_phoc(word))
