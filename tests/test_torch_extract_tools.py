"""The port's device tools against the JAX package's on the CPU, at tiny
configurations (the 1-1-1-1 FRCNN and ResNet at full width, a narrow BERT),
the JAX weights carried across: ``extract_ocr_features`` (RoIPool on forced
OCR boxes: degenerate, edge-touching and empty sets), ``extract_grid_feats``
and ``extract_bert_embeddings``, each within 1e-6 + 1e-5 · max|ref|, their
file protocols (dedupe, ``.lock`` files, group sharding) equal; and each
tool's ``--device cuda`` raising where there is no card."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from transformer_mm_explainability_tpu.data.tokenization import (
    BertTokenizer as JBertTokenizer)
from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import frcnn as jfrcnn
from transformer_mm_explainability_tpu.models import resnet as jresnet
from transformer_mm_explainability_tpu.tools import (
    extract_bert_embeddings as jebe)
from transformer_mm_explainability_tpu.tools import extract_grid_feats as jgrid
from transformer_mm_explainability_tpu.tools import extract_ocr_features as jocr
from transformer_mm_explainability_tpu_torch.data.tokenization import (
    BertTokenizer)
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import frcnn as tfrcnn
from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas
from transformer_mm_explainability_tpu_torch.tools import (
    extract_bert_embeddings as ebe)
from transformer_mm_explainability_tpu_torch.tools import extract_grid_feats
from transformer_mm_explainability_tpu_torch.tools import (
    extract_ocr_features as ocr)
from transformer_mm_explainability_tpu_torch.utils import convert

TOL = dict(rtol=1e-5, atol=1e-6)
FRCNN_TINY = dict(stages=(1, 1, 1, 1), pooler_resolution=7, num_classes=5,
                  num_attrs=3, pre_nms_topk=50, post_nms_topk=10,
                  max_detections=4)
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a CUDA device is present")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    """max|got − want| ≤ atol + rtol · max|want|: the bar is relative to the
    largest value (as ``test_torch_extract_features`` holds its features),
    since fp32 sums run in another order on each side and the JAX init's
    features reach tens to thousands."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bar = TOL["atol"] + TOL["rtol"] * float(np.abs(want).max(initial=0.0))
    assert float(np.abs(got - want).max(initial=0.0)) <= bar


def numpy_tree(init, seed):
    """``init()``'s JAX tree (its shapes by ``jax.eval_shape``, nothing
    compiled) drawn with numpy: convs He-scaled, frozen BN and LN near
    identity, every other leaf std 0.02."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        key = getattr(path[-1], "key", None)
        if key == "var":
            x = 1 + 0.1 * rng.rand(*s.shape)
        elif key in ("weight", "scale"):
            x = 1 + 0.1 * rng.randn(*s.shape)
        elif key == "mean":
            x = 0.1 * rng.randn(*s.shape)
        elif len(s.shape) == 4:                        # HWIO conv
            x = rng.randn(*s.shape) * (2.0 / np.prod(s.shape[:3])) ** 0.5
        else:
            x = 0.02 * rng.randn(*s.shape)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


# ------------------------------------------------------------ OCR / FRCNN
@pytest.fixture(scope="module")
def frcnn_pair():
    jcfg = jfrcnn.FrcnnConfig(**FRCNN_TINY)
    tcfg = tfrcnn.FrcnnConfig(**FRCNN_TINY)
    jp = numpy_tree(lambda: jfrcnn.init_params(jax.random.PRNGKey(0), jcfg),
                    0)
    tp = convert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                      device="cpu")
    return jp, jcfg, tp, tcfg


def _image(seed, h=48, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# pixel boxes on a 48×64 image: ordinary, zero width, zero height, a
# point, the whole image, the right/bottom edge, a 1-pixel sliver
OCR_BOXES = np.array([[2.0, 2.0, 40.0, 30.0], [10.0, 5.0, 10.0, 45.0],
                      [3.0, 20.0, 50.0, 20.0], [30.0, 30.0, 30.0, 30.0],
                      [0.0, 0.0, 64.0, 48.0], [50.0, 40.0, 64.0, 48.0],
                      [63.0, 0.0, 64.0, 1.0]], np.float32)


def test_image_scale_matches_jax():
    for h, w in ((400, 600), (300, 1200), (600, 1000), (48, 64), (1, 5000)):
        for target, cap in ((800, 1333), (48, 80), (32, 0)):
            assert ocr.image_scale(h, w, target, cap) == \
                jocr.image_scale(h, w, target, cap)


@pytest.mark.parametrize("boxes", ["ocr", "edge_and_degenerate", "empty"])
def test_ocr_roi_features_match_jax(frcnn_pair, boxes):
    """[K, 2048] within rtol 1e-5 / atol 1e-6 of the JAX tool; the pooled
    map equal to the bit to JAX's ``roi_pool`` on the port's own res4 map
    and scaled boxes; the kernel's wrapper and the plain route agree."""
    jp, jcfg, tp, tcfg = frcnn_pair
    img = _image(0)
    b = {"ocr": OCR_BOXES[:2], "edge_and_degenerate": OCR_BOXES,
         "empty": OCR_BOXES[:0]}[boxes]
    got = ocr.ocr_roi_features(tp, img, b, tcfg, target=48, cap=80)
    want = jocr.ocr_roi_features(jp, img, b, jcfg, target=48, cap=80)
    assert got.shape == want.shape == (len(b), 2048)
    assert got.dtype == np.float32
    _close(got, want)
    if not len(b):
        return
    assert np.isfinite(got).all() and np.abs(got[0] - got[1]).max() > 0
    feats, scaled = ocr.ocr_pool_inputs(tp, img, b, tcfg, target=48, cap=80)
    assert scaled.dtype == torch.float32
    pooled = roi_pool_pallas.roi_pool_pallas(feats, scaled, 7, 1 / 16)
    ref = jfrcnn.roi_pool(jax.numpy.asarray(feats.numpy()),
                          jax.numpy.asarray(scaled.numpy()), 7, 1 / 16)
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(ref))
    xla = tfrcnn.FrcnnConfig(**FRCNN_TINY, roi_pool_impl="xla")
    np.testing.assert_array_equal(
        ocr.ocr_roi_features(tp, img, b, xla, target=48, cap=80), got)


def _imdb(tmp_path):
    images = {"a.png": _image(1, 32, 40), "c.png": _image(2, 48, 64)}
    for name, arr in images.items():
        Image.fromarray(arr).save(tmp_path / name)
    row = lambda iid, path, w, h, boxes, toks: {
        "image_id": iid, "image_path": path, "feature_path": f"train/{iid}.npy",
        "image_width": w, "image_height": h,
        "ocr_normalized_boxes": boxes, "ocr_tokens": toks}
    return [
        row("c", "c.png", 64, 48, (OCR_BOXES / [64, 48, 64, 48]).tolist(),
            [f"t{i}" for i in range(len(OCR_BOXES))]),
        row("a", "a.png", 40, 32, [[0.1, 0.1, 0.6, 0.8]], ["stop"]),
        row("a", "a.png", 40, 32, [[0.1, 0.1, 0.6, 0.8]], ["stop"]),
        row("b", "missing.png", 40, 32, [], []),
    ]


def test_extract_from_imdb_matches_jax(frcnn_pair, tmp_path):
    """Deduped, sorted entries; the info files equal byte for byte, the
    features within tolerance; an image without boxes gives [0, 2048]
    without being read."""
    jp, jcfg, tp, tcfg = frcnn_pair
    imdb = _imdb(tmp_path)
    got = ocr.extract_from_imdb(tp, imdb, str(tmp_path),
                                str(tmp_path / "port"), tcfg, 32, 64)
    want = jocr.extract_from_imdb(jp, imdb, str(tmp_path),
                                  str(tmp_path / "jax"), jcfg, 32, 64)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want] == \
        ["train/a.npy", "train/b.npy", "train/c.npy"]
    for iid, k in (("a", 1), ("b", 0), ("c", len(OCR_BOXES))):
        f = np.load(tmp_path / "port" / "train" / f"{iid}.npy")
        assert f.shape == (k, 2048)
        _close(f, np.load(tmp_path / "jax" / "train" / f"{iid}.npy"))
        info = f"train/{iid}_info.npy"
        assert (tmp_path / "port" / info).read_bytes() == \
            (tmp_path / "jax" / info).read_bytes()


def test_ocr_cli_on_the_cpu(frcnn_pair, tmp_path, monkeypatch):
    """``main --device cpu`` (FRCNN_VG narrowed to the tiny stages by
    monkeypatch) writes what ``extract_from_imdb`` writes with the same
    seed's weights; ``--device cuda`` raises without a card."""
    _, _, _, tcfg = frcnn_pair
    monkeypatch.setattr(tfrcnn, "FRCNN_VG", tcfg)
    np.save(tmp_path / "imdb.npy", np.array([{"version": 1}] + _imdb(tmp_path),
                                            dtype=object))
    argv = ["--imdb_file", str(tmp_path / "imdb.npy"), "--image_dir",
            str(tmp_path), "--save_dir", str(tmp_path / "cli"), "--seed", "3"]
    assert ocr.main(argv + ["--device", "cpu"]) == 0
    params = tfrcnn.init_params(3, tcfg, "cpu")
    ocr.extract_from_imdb(params, _imdb(tmp_path), str(tmp_path),
                          str(tmp_path / "ref"), tcfg, 32, 64)
    f = np.load(tmp_path / "cli" / "train" / "c.npy")
    assert f.shape == (len(OCR_BOXES), 2048)
    # the CLI runs at 800 px, the reference call at 32: only shapes agree
    assert np.load(tmp_path / "ref" / "train" / "c.npy").shape == f.shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ocr.main(argv + ["--device", "cuda"])


# ------------------------------------------------------------- grid feats
def test_preprocess_image_matches_jax():
    rng = np.random.RandomState(0)
    for img in ((rng.rand(64, 48, 3) * 255).astype(np.uint8),
                (rng.rand(30, 50) * 255).astype(np.uint8),
                (rng.rand(20, 20, 1) * 255).astype(np.uint8)):
        got = extract_grid_feats.preprocess_image(img)
        assert got.shape == (448, 448, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jgrid.preprocess_image(img))
    assert extract_grid_feats.get_image_id("COCO_val_000000000042.jpg") == 42


@pytest.fixture(scope="module")
def trunks():
    jp = numpy_tree(lambda: jresnet.init_params(jax.random.PRNGKey(1),
                                                stages=(1, 1, 1, 1)), 1)
    tp = convert._to_torch(jax.tree.map(np.asarray, jp), "cpu", hwio=True)
    return (jgrid.make_trunk(stages=(1, 1, 1, 1), params=jp),
            extract_grid_feats.make_trunk(stages=(1, 1, 1, 1), params=tp,
                                          device="cpu"))


def test_extract_dataset_pool5_matches_jax(trunks, tmp_path):
    """Two shards at 448×448: the same files, [1, 14, 14, 2048] features
    within tolerance; completed files skipped; a stale ``.lock`` redone."""
    jtrunk, ttrunk = trunks
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        arr = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"COCO_val_{i:012d}.jpg")
    Image.fromarray((rng.rand(16, 16) * 255).astype(np.uint8)).save(
        img_dir / "COCO_val_000000000005.jpg")           # grey
    out = {}
    for side, mod, trunk in (("jax", jgrid, jtrunk),
                             ("port", extract_grid_feats, ttrunk)):
        d = str(tmp_path / side)
        even = mod.extract_dataset_pool5(str(img_dir), d, 2, 0, trunk=trunk,
                                         batch_size=2)
        odd = mod.extract_dataset_pool5(str(img_dir), d, 2, 1, trunk=trunk,
                                        batch_size=2)
        assert mod.extract_dataset_pool5(str(img_dir), d, 2, 0,
                                         trunk=trunk) == []
        out[side] = [os.path.basename(p) for p in even + odd]
    assert out["port"] == out["jax"] == [
        "COCO_val_000000000000.npy", "COCO_val_000000000002.npy",
        "COCO_val_000000000001.npy", "COCO_val_000000000005.npy"]
    for name in out["port"]:
        f = np.load(tmp_path / "port" / name)
        assert f.shape == (1, 14, 14, 2048)
        _close(f, np.load(tmp_path / "jax" / name))
    victim = tmp_path / "port" / "COCO_val_000000000002.npy"
    os.makedirs(str(victim) + ".lock")
    np.save(victim, np.zeros((1, 1, 1, 1), np.float32))
    redo = extract_grid_feats.extract_dataset_pool5(
        str(img_dir), str(tmp_path / "port"), 2, 0, trunk=ttrunk)
    assert [os.path.basename(p) for p in redo] == [victim.name]
    assert not os.path.exists(str(victim) + ".lock")
    _close(np.load(victim), np.load(tmp_path / "jax" / victim.name))


@NO_CARD
def test_grid_cli_needs_a_card_when_asked(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_grid_feats.main(["--data_dir", str(tmp_path), "--out_dir",
                                 str(tmp_path / "o"), "--device", "cuda"])


# ------------------------------------------------------------------ BERT
BERT_TINY = dict(vocab_size=30, hidden_size=16, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "color", "is", "the",
         "cat", "dog"]
QUESTIONS = [{"question_id": 11, "question_str": "what color is the cat"},
             {"question_id": 12, "question_str": "what is the dog"},
             {"question_id": 13, "question_str": "the cat"},
             {"question_id": 14, "question_str": "Is the DOG a cat?"},
             {"question_id": 15, "question_str": "what"}]


@pytest.fixture(scope="module")
def bert_pair():
    jcfg = jbert.BertConfig(**BERT_TINY)
    jp = numpy_tree(lambda: {
        "emb": jbert.init_embedding_params(jax.random.PRNGKey(0), jcfg),
        "enc": jbert.init_encoder_params(jax.random.PRNGKey(1), jcfg)}, 2)
    tp = convert._to_torch(jax.tree.map(np.asarray, jp), "cpu")
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return (jp, jcfg, JBertTokenizer(vocab=vocab), tp,
            tbert.BertConfig(**BERT_TINY), BertTokenizer(vocab=vocab))


@pytest.mark.parametrize("group", [(0, 1), (1, 2)])
def test_extract_bert_matches_jax(bert_pair, tmp_path, group):
    """The same files per shard, each [CLS] vector within tolerance, and
    padding-invariant (a wider ``max_seq_length`` gives the same vector)."""
    jp, jcfg, jtok, tp, tcfg, ttok = bert_pair
    gid, n = group
    got = ebe.extract_bert(tp, tcfg, ttok, QUESTIONS, str(tmp_path) + "/t_",
                           gid, n, max_seq_length=12, batch_size=2)
    want = jebe.extract_bert(jp, jcfg, jtok, QUESTIONS, str(tmp_path) + "/j_",
                             gid, n, max_seq_length=12, batch_size=2)
    names = [os.path.basename(p)[2:] for p in got]
    assert names == [os.path.basename(p)[2:] for p in want]
    assert names == [f"{q['question_id']}.npy" for q in QUESTIONS[gid::n]]
    for g, w in zip(got, want):
        a = np.load(g)
        assert a.shape == (16,) and a.dtype == np.float32
        _close(a, np.load(w))
    wide = ebe.extract_bert(tp, tcfg, ttok, QUESTIONS[gid:gid + 1],
                            str(tmp_path) + "/w_", max_seq_length=20)
    _close(np.load(wide[0]), np.load(got[0]))


def test_bert_cli_on_the_cpu(bert_pair, tmp_path, monkeypatch):
    """``main --device cpu`` (BERT_BASE narrowed by monkeypatch) over an
    imdb and a vocabulary file equals ``extract_bert`` with the seed's
    weights; ``--device cuda`` raises without a card."""
    ttok = bert_pair[5]
    tcfg = tbert.BertConfig(**{**BERT_TINY, "max_position_embeddings": 64})
    monkeypatch.setattr(tbert, "BERT_BASE", tcfg)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    np.save(tmp_path / "imdb.npy",
            np.array([{"version": 1}] + QUESTIONS, dtype=object))
    argv = ["--imdb_path", str(tmp_path / "imdb.npy"), "--out_path",
            str(tmp_path) + "/cli_", "--vocab_file",
            str(tmp_path / "vocab.txt"), "--seed", "4"]
    assert ebe.main(argv + ["--device", "cpu"]) == 0
    gen = torch.Generator().manual_seed(4)
    params = {"emb": tbert.init_embedding_params(gen, tcfg, "cpu"),
              "enc": tbert.init_encoder_params(gen, tcfg, "cpu")}
    ref = ebe.extract_bert(params, tcfg, ttok, QUESTIONS,
                           str(tmp_path) + "/ref_")
    for q, r in zip(QUESTIONS, ref):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"cli_{q['question_id']}.npy"), np.load(r))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ebe.main(argv + ["--device", "cuda"])
