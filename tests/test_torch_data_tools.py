"""The port's host data tools against the JAX package's: each tool runs on
the same generated inputs into two directories, and every file written
(json, txt, npy, imdb, LMDB records, sbatch scripts) must be equal byte
for byte, as must the returned values and printed lines.

``lmdb`` is optional and absent here: ``lmdb_tools`` runs through an
in-memory fake on both sides (as the JAX tests drive it), and without the
fake the port raises ImportError."""

import io
import json
import os
import pickle
import sys
import tarfile
import warnings
import zipfile

import numpy as np
import pytest

from transformer_mm_explainability_tpu.tools import extract_vocab as jev
from transformer_mm_explainability_tpu.tools import gqa_to_vqa as jgqa
from transformer_mm_explainability_tpu.tools import hm_convert as jhm
from transformer_mm_explainability_tpu.tools import lmdb_tools as jlmdb
from transformer_mm_explainability_tpu.tools import process_answers as jpa
from transformer_mm_explainability_tpu.tools import process_data as jpd
from transformer_mm_explainability_tpu.tools import sweep as jsweep
from transformer_mm_explainability_tpu.tools import visdial_imdb as jvd
from transformer_mm_explainability_tpu_torch.tools import extract_vocab as tev
from transformer_mm_explainability_tpu_torch.tools import gqa_to_vqa as tgqa
from transformer_mm_explainability_tpu_torch.tools import hm_convert as thm
from transformer_mm_explainability_tpu_torch.tools import lmdb_tools as tlmdb
from transformer_mm_explainability_tpu_torch.tools import process_answers as tpa
from transformer_mm_explainability_tpu_torch.tools import process_data as tpd
from transformer_mm_explainability_tpu_torch.tools import sweep as tsweep
from transformer_mm_explainability_tpu_torch.tools import visdial_imdb as tvd

WORDS = ["what", "color", "is", "the", "dog's", "cat", "sky", "how", "many",
         "two", "Red", "blue", "sign", "says", "stop", "a", "man", "horse"]
ANSWERS = ["red", "Blue", "two", "2", "yes", "no", "a dog", "the cat",
           "three", "stop sign", "none", "10"]


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    root = str(root)
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_trees(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k


def _question(rng) -> str:
    n = rng.randint(3, 9)
    return " ".join(WORDS[i] for i in rng.randint(0, len(WORDS), n)) + \
        ("?" if rng.rand() < 0.7 else ",")


# ------------------------------------------------------ process_answers
def test_process_answers_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(0)
    ann = lambda n, off: {"annotations": [
        {"question_id": off + i,
         "multiple_choice_answer": ANSWERS[rng.randint(len(ANSWERS))]}
        for i in range(n)]}
    (tmp_path / "train.json").write_text(json.dumps(ann(40, 0)))
    (tmp_path / "val.json").write_text(json.dumps(ann(20, 100)))
    assert [tpa.get_score(k) for k in range(6)] == \
        [jpa.get_score(k) for k in range(6)]
    assert tpa.multiple_replace("a b c", {"a": "x", "c": "z"}) == \
        jpa.multiple_replace("a b c", {"a": "x", "c": "z"})
    printed = []
    for mod, side in ((jpa, "jax"), (tpa, "port")):
        mod.main(["--annotation_file", str(tmp_path / "train.json"),
                  "--val_annotation_file", str(tmp_path / "val.json"),
                  "--out_dir", str(tmp_path / side), "--min_freq", "2"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "appear >= 2 times" in printed[0]
    _same_trees(tmp_path / "jax", tmp_path / "port")
    words = (tmp_path / "port" / "answers_vqa.txt").read_text().split("\n")
    assert words[0] == "<unk>" and words[1:-1] == sorted(words[1:-1])


# --------------------------------------------------------- process_data
@pytest.mark.parametrize("task", ["gqa", "nlvr2"])
def test_process_data_matches_jax(tmp_path, task):
    rng = np.random.RandomState(1)
    raw = tmp_path / "raw"
    raw.mkdir()
    if task == "gqa":
        for split, name in jpd.GQA_SPLIT2NAME.items():
            qs = {f"{split}{i}": {"imageId": f"n{rng.randint(99)}",
                                  "question": _question(rng),
                                  **({"answer": ANSWERS[i % 12]}
                                     if split != "test" else {})}
                  for i in range(5)}
            (raw / f"{name}_balanced_questions.json").write_text(
                json.dumps(qs))
    else:
        for split, fname in jpd.NLVR2_SPLIT2FNAME.items():
            (raw / f"{fname}.json").write_text("".join(
                json.dumps({"identifier": f"{split}-{i}-0-{i % 2}",
                            "label": "True" if i % 3 else "False",
                            "sentence": _question(rng)}) + "\n"
                for i in range(6)))
    for mod, side in ((jpd, "jax"), (tpd, "port")):
        (tmp_path / side).mkdir()
        mod.main([task, "--data-root", str(raw), "--out-dir",
                  str(tmp_path / side)])
    _same_trees(tmp_path / "jax", tmp_path / "port")
    assert len(_tree(tmp_path / "port")) == \
        (5 if task == "gqa" else 3)


# -------------------------------------------------------- extract_vocab
def test_extract_vocab_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(2)
    files = []
    for k in range(2):
        qs = [_question(rng) for _ in range(20)]
        if k:
            qs = [{"question": q} for q in qs]
        files.append(tmp_path / f"q{k}.json")
        files[-1].write_text(json.dumps({"questions": qs}))
    texts = tev.texts_from_question_files(map(str, files))
    assert texts == jev.texts_from_question_files(map(str, files))
    assert tev.extract_vocabulary(texts, 2) == \
        jev.extract_vocabulary(texts, 2)
    printed = []
    for mod, side in ((jev, "jax"), (tev, "port")):
        mod.main(["--input_files", *map(str, files), "--out_dir",
                  str(tmp_path / side), "--min_freq", "1"])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "max text len=" in printed[0]
    _same_trees(tmp_path / "jax", tmp_path / "port")


# ------------------------------------------------------------ gqa_to_vqa
def _gqa_dir(root, rng):
    """A GQA release in miniature: two h5 shards of objects and of spatial
    grids with their info jsons, and the balanced / all question files of
    three splits (train split chunked)."""
    import h5py

    objs, spatial, qdir = (root / "images" / "objects",
                           root / "images" / "spatial", root / "questions")
    for d in (objs, spatial, qdir / "train_all_questions"):
        d.mkdir(parents=True)
    info_o, info_s = {}, {}
    for f in range(2):
        with h5py.File(objs / f"gqa_objects_{f}.h5", "w") as h:
            h["bboxes"] = rng.rand(3, 5, 4).astype(np.float32)
            h["features"] = rng.rand(3, 5, 8).astype(np.float32)
        with h5py.File(spatial / f"gqa_spatial_{f}.h5", "w") as h:
            h["features"] = rng.rand(3, 2048, 7, 7).astype(np.float32)
        for i in range(3):
            info_o[f"n{f}{i}"] = {"file": f, "idx": i, "height": 10 + i,
                                  "width": 20 + f, "objectsNum": 5}
            info_s[f"n{f}{i}"] = {"file": f, "idx": 2 - i}
    (objs / "gqa_objects_info.json").write_text(json.dumps(info_o))
    (spatial / "gqa_spatial_info.json").write_text(json.dumps(info_s))

    def questions(prefix, n):
        return {f"{prefix}{i}": {
            "imageId": f"n{i % 2}{i % 3}", "question": _question(rng),
            "answer": ANSWERS[rng.randint(len(ANSWERS))],
            "semanticStr": f"select: dog ({100 + i})->relate: "
                           f"on,s ({i},{i + 1})->query: color",
            "types": {"structural": "query"}} for i in range(n)}

    for split in ("val", "challenge"):
        for kind in ("balanced", "all"):
            (qdir / f"{split}_{kind}_questions.json").write_text(
                json.dumps(questions(f"{split}{kind}", 4)))
    for c in range(2):
        (qdir / "train_all_questions" / f"chunk{c}.json").write_text(
            json.dumps(questions(f"train{c}_", 3)))
    (qdir / "train_balanced_questions.json").write_text(
        json.dumps(questions("trainb", 3)))


def test_gqa_to_vqa_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    assert tgqa.get_objects("select: x (12)->y (3,4)->z (a)") == \
        jgqa.get_objects("select: x (12)->y (3,4)->z (a)") == [12, 3, 4]
    for side, mod in (("jax", jgqa), ("port", tgqa)):
        src = tmp_path / f"gqa_{side}"
        _gqa_dir(src, np.random.RandomState(3))
        mod.convert_gqa_to_vqa(str(src), str(tmp_path / side), n_files=2)
    _same_trees(tmp_path / "jax", tmp_path / "port")
    merged = "questions/train_all_questions.json"       # merged train
    assert (tmp_path / "gqa_jax" / merged).read_bytes() == \
        (tmp_path / "gqa_port" / merged).read_bytes()
    grid = np.load(tmp_path / "port" / "spatial" / "n11.npy")
    assert grid.shape == (1, 7, 7, 2048)
    imdb = np.load(tmp_path / "port" / "imdb_val_balanced.npy",
                   allow_pickle=True)
    assert imdb[0] == {"dataset_name": "gqa"} and len(imdb) == 5


# ---------------------------------------------------------- visdial_imdb
def test_visdial_imdb_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    coco = tmp_path / "COCO"
    for split in ("train2014", "val2014"):
        (coco / split).mkdir(parents=True)
    ids = [11, 250, 31337]
    for k, i in enumerate(ids):
        split = "train2014" if k % 2 == 0 else "val2014"
        np.save(coco / split / f"COCO_{split}_{i:012d}.npy",
                np.zeros(2, np.float32))
    data = {"questions": [_question(rng) for _ in range(6)],
            "answers": [_question(rng) for _ in range(6)],
            "dialogs": [{"image_id": i, "caption": _question(rng),
                         "dialog": [{"question": 0, "answer": 1}]}
                        for i in ids]}
    vd = tmp_path / "visdial"
    vd.mkdir()
    (vd / "visdial_1.0_val.json").write_text(json.dumps({"data": data}))
    for mod, side in ((jvd, "jax"), (tvd, "port")):
        (tmp_path / side).mkdir()
        mod.main(["-o", str(tmp_path / side / "imdb.json"), "-i", str(coco),
                  "-v", "1.0", "-d", str(vd), "-s", "val"])
    _same_trees(tmp_path / "jax", tmp_path / "port")
    imdb = json.loads((tmp_path / "port" / "imdb.json").read_text())
    assert imdb["dialogs"][1]["image_feature_path"] == \
        "val2014/COCO_val2014_000000000250.npy"


# ------------------------------------------------------------ hm_convert
def _hm_zip(phase_two: bool, tar_images: bool) -> bytes:
    """A DrivenData-shaped zip: data/{*.jsonl, img/ or img.tar.gz}."""
    jsonls = (jhm.JSONL_PHASE_TWO_FILES if phase_two
              else jhm.JSONL_PHASE_ONE_FILES)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for k, name in enumerate(jsonls):
            z.writestr(f"data/{name}", json.dumps(
                {"id": k, "img": f"img/{k}.png", "label": k % 2,
                 "text": "hello"}) + "\n")
        if tar_images:
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w:gz") as tar:
                png = b"\x89PNG fake"
                info = tarfile.TarInfo("img/00001.png")
                info.size = len(png)
                tar.addfile(info, io.BytesIO(png))
            z.writestr("data/img.tar.gz", buf.getvalue())
        else:
            z.writestr("data/img/00001.png", b"\x89PNG fake")
    return out.getvalue()


@pytest.mark.parametrize("phase_two,tar_images", [(True, True),
                                                  (False, False)])
def test_hm_convert_matches_jax(tmp_path, phase_two, tar_images):
    blob = _hm_zip(phase_two, tar_images)
    bases = []
    for mod, side in ((jhm, "jax"), (thm, "port")):
        z = tmp_path / f"{side}_zip" / "hateful_memes.zip"
        z.parent.mkdir()
        z.write_bytes(blob)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bases.append(mod.convert(str(z), str(tmp_path / side),
                                     bypass_checksum=True))
        phase = [str(w.message) for w in caught
                 if issubclass(w.category, UserWarning)]
        assert len(phase) == (0 if phase_two else 1), phase
    assert bases[1] == bases[0].replace(str(tmp_path / "jax"),
                                        str(tmp_path / "port"))
    _same_trees(tmp_path / "jax", tmp_path / "port")
    assert thm.POSSIBLE_CHECKSUMS == jhm.POSSIBLE_CHECKSUMS
    with pytest.raises(AssertionError, match="Checksum"):
        thm.convert(str(tmp_path / "port_zip" / "hateful_memes.zip"),
                    str(tmp_path / "x"))
    (tmp_path / "empty" / "data").mkdir(parents=True)
    for name in thm.JSONL_PHASE_TWO_FILES:
        (tmp_path / "empty" / "data" / name).write_text("{}\n")
    with pytest.raises(AssertionError, match="img"):
        thm.assert_files(str(tmp_path / "empty"))


# ------------------------------------------------------------ lmdb_tools
class _FakeTxn:
    def __init__(self, store):
        self._store = store

    def put(self, key, value):
        self._store[bytes(key)] = bytes(value)

    def get(self, key):
        return self._store.get(bytes(key))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeLmdb:
    """The open/begin/put/get surface the tool uses, in memory."""

    def __init__(self):
        self.dbs = {}

    def open(self, path, **kw):
        store = self.dbs.setdefault(path, {})
        return type("Env", (), {"begin": lambda self, **kw: _FakeTxn(store)})()


def test_lmdb_tools_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "feats"
    (src / "train2014").mkdir(parents=True)
    for name, n in (("coco_1", 4), ("coco_2", 7), ("train2014/coco_3", 2)):
        np.save(src / f"{name}.npy", rng.randn(n, 16).astype(np.float32))
        if name != "coco_2":
            np.save(src / f"{name}_info.npy", {
                "image_height": 480, "image_width": 640, "num_boxes": n,
                "objects": np.arange(n), "cls_prob": None,
                "bbox": rng.rand(n, 4).astype(np.float32)})
    fakes = {}
    for mod, side in ((jlmdb, "jax"), (tlmdb, "port")):
        fakes[side] = _FakeLmdb()
        keys = mod.convert_dir_to_lmdb(str(src), "db",
                                       lmdb_module=fakes[side])
        assert keys == [b"coco_1", b"coco_2", b"train2014/coco_3"]
        ids = mod.extract_lmdb_to_dir("db", str(tmp_path / side),
                                      lmdb_module=fakes[side])
        assert ids == [k.decode() for k in keys]
    assert fakes["jax"].dbs == fakes["port"].dbs       # pickled records
    rec = pickle.loads(fakes["port"].dbs["db"][b"coco_1"])
    assert rec["image_height"] == 480 and rec["feature_path"] == "coco_1"
    _same_trees(tmp_path / "jax", tmp_path / "port")
    info = np.load(tmp_path / "port" / "coco_1_info.npy",
                   allow_pickle=True).item()
    assert info["image_height"] == 480 and info["image_width"] == 640


def test_lmdb_tools_without_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)   # import fails
    with pytest.raises(ImportError, match="optional 'lmdb'"):
        tlmdb.convert_dir_to_lmdb("x", "y")


# ----------------------------------------------------------------- sweep
def test_sweep_matches_jax(tmp_path, monkeypatch):
    """Grid, run dirs, local runs (a failing command reports failed) and
    sbatch scripts: the same on both sides, but for the sweep root."""
    monkeypatch.chdir(tmp_path)       # no git checkout: no code snapshot
    for mod, side in ((jsweep, "jax"), (tsweep, "port")):
        root = str(tmp_path / side)
        sw = mod.Sweep("unit", "true", [mod.Param("lr", [0.1, 0.2]),
                                        mod.Param("seed", [1])],
                       sweep_root=root)
        assert len(sw.grid()) == 2
        sw.launch(backend="local")
        assert [sw.state(c) for c in sw.grid()] == ["finished"] * 2
        bad = mod.Sweep("bad", "false", [mod.Param("x", [1])],
                        sweep_root=root)
        bad.launch(backend="local")
        assert bad.state({"x": 1}) == "failed"
        scripts = sw.launch(backend="slurm", dry_run=True)
        assert len(scripts) == 2
    ta, tb = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].replace(str(tmp_path / "jax").encode(),
                             str(tmp_path / "port").encode()) == tb[k], k
