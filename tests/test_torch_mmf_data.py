"""The port's MMF data layer against the JAX package: every registered
processor (``phoc`` waits for ``native/``), the databases and feature
readers, every registered builder (the VQA family, NLVR2, COCO, the OCR
family, the zoo tail and the masked pretraining datasets) through to
collated batches, ``MultiDatasetLoader``, the text decoders, the LXMERT
answer table and pretraining data.

Every case writes its files once from a seed, then builds the same
processor or dataset from the same config on both sides and reads the same
items in the same order: outputs, masks (the seeded RNGs draw in the same
order) and collated batches must be equal exactly (dtype, shape, values),
but ``torchvision_transforms``' resize, which runs through the port's
``ops/image`` (``F.interpolate`` with antialias) where the JAX package
runs ``jax.image.resize``: atol 1e-4 on [0, 1] pixels.
"""

import json

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.core import sample as JS
from transformer_mm_explainability_tpu.core.registry import (
    registry as jregistry)
from transformer_mm_explainability_tpu.data import databases as JD
from transformer_mm_explainability_tpu.data import extra_builders  # noqa: F401
from transformer_mm_explainability_tpu.data import lxmert_pretrain_data as JP
from transformer_mm_explainability_tpu.data import masked_datasets  # noqa: F401
from transformer_mm_explainability_tpu.data import multi_dataset as JMD
from transformer_mm_explainability_tpu.data import processors as JPR
from transformer_mm_explainability_tpu.data import qa_answer_table as JQ
from transformer_mm_explainability_tpu.data import text_utils as JT
from transformer_mm_explainability_tpu_torch.core import env as tenv
from transformer_mm_explainability_tpu_torch.core import sample as TS
from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.data import databases as TD
from transformer_mm_explainability_tpu_torch.data import (
    lxmert_pretrain_data as TP)
from transformer_mm_explainability_tpu_torch.data import multi_dataset as TMD
from transformer_mm_explainability_tpu_torch.data import qa_answer_table as TQ
from transformer_mm_explainability_tpu_torch.data import text_utils as TT

tenv.setup_imports()

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "color",
         "is", "the", "dog", "cat", "red", "blue", "it", "'", "s", "a",
         "an", "##s", "true", "two", "dogs", "are", "sitting", "sign",
         "says", "stop", "movie", "about", "space", "man", "rides",
         "horse", "sky", "birds", "runs"]
VOCAB_D = {w: i for i, w in enumerate(VOCAB)}
BERT = {"type": "bert_tokenizer",
        "params": {"tokenizer_config": {"vocab": VOCAB_D},
                   "max_seq_length": 16}}
VQA_ANSWER = {"type": "vqa_answer",
              "params": {"vocab": ["red", "blue", "sky"],
                         "preprocessor": "simple_word"}}
MASKS = {"masked_token_processor": {
    "type": "masked_token",
    "params": {"tokenizer_config": {"vocab": VOCAB_D}, "max_seq_length": 16,
               "mask_probability": 0.3, "seed": 3}},
    "masked_region_processor": {"type": "masked_region",
                                "params": {"seed": 5}}}


def same(a, b, path="item"):
    """Deep equality: numpy arrays by dtype, shape and value; dicts by
    keys; sequences by length; scalars by type and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, a, b)
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (
            path, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            same(a.tolist(), b.tolist(), path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (
            path, a, b)


# ---------------------------------------------------------------------------
# files, written once for the module
# ---------------------------------------------------------------------------

def _features(root, name, n=7, dim=12, seed=0):
    rng = np.random.RandomState(seed)
    path = root / f"{name}.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, rng.randn(n, dim).astype(np.float32))
    np.save(root / f"{name}_info.npy", np.array(
        {"image_width": 640, "image_height": 480,
         "bbox": rng.rand(n, 4).astype(np.float32) * 400}, dtype=object))


def _jsonl(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows))
    return str(path)


def _imdb(path, rows):
    np.save(path, np.array([{"metadata": True}] + rows, dtype=object))
    return str(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from PIL import Image

    r = tmp_path_factory.mktemp("mmf")
    for i, name in enumerate(["img7", "img8", "tv/img1", "keepme",
                              "train/img9", "1000092795", "03456", "m1",
                              "901", "cc1", "COCO_cap1", "img_1", "img_2",
                              "img_5", "img_6", "dev-0-0-img0",
                              "dev-0-0-img1"]):
        _features(r, name, seed=i)
    (r / "ft.txt").write_text("\n".join(
        " ".join([w] + [f"{0.1 * (i + 1):.2f}"] * 4)
        for i, w in enumerate(["stop", "sign", "go", "red"])))
    (r / "img").mkdir()
    Image.new("RGB", (8, 6), (255, 0, 0)).save(r / "img/03456.png")
    Image.new("RGB", (8, 6), (10, 20, 30)).save(r / "hat7.jpg")
    (r / "images/train").mkdir(parents=True)
    Image.new("RGB", (8, 6), (0, 128, 255)).save(
        r / "images/train/CLEVR_train_000000.png")
    (r / "questions").mkdir()
    (r / "questions/CLEVR_train_questions.json").write_text(json.dumps(
        {"questions": [{"question": "what color is the dog?",
                        "answer": "red",
                        "image_filename": "CLEVR_train_000000.png"}]}))
    return r


def _ocr_processors(root, caption=False):
    return {
        "text_processor": BERT,
        "answer_processor": {
            "type": "m4c_caption" if caption else "m4c_answer",
            "params": {"vocab": ["<pad>", "<s>", "</s>", "<unk>", "red",
                                "stop"],
                       "preprocessor": {"type": "simple_word"},
                       "num_answers": 1 if caption else 10,
                       "max_length": 8, "max_copy_steps": 4}},
        "copy_processor": {"type": "copy", "params": {"max_length": 100}},
        "context_processor": {"type": "fasttext",
                              "params": {"model_file": str(root / "ft.txt"),
                                         "max_length": 8}},
        "ocr_token_processor": {"type": "simple_word"},
    }


def _textvqa_row(feature_path="tv/img1.npy", image_path="tv/img1.jpg",
                 qid=77):
    return {"question": "what says the sign", "question_id": qid,
            "image_id": 5, "feature_path": feature_path,
            "image_path": image_path,
            "obj_normalized_boxes": np.random.RandomState(0).rand(
                7, 4).astype(np.float32).tolist(),
            "ocr_tokens": ["STOP", "sign"],
            "ocr_normalized_boxes": [[0.1, 0.1, 0.4, 0.4],
                                     [0.5, 0.5, 0.9, 0.9]],
            "answers": ["stop"] * 10}


def _ocr_cfg(root, name, rows, caption=False):
    return {"annotations": _jsonl(root / f"{name}.jsonl", rows),
            "features": str(root), "max_features": 10, "use_ocr": True,
            "use_order_vectors": True,
            "processors": _ocr_processors(root, caption)}


def builder_case(root, case):
    """(builder name, config, dataset type) of one builder case."""
    feats = {"features": str(root), "max_features": 10}
    if case in ("vqa2", "gqa", "okvqa"):
        rows = [{"image_id": 7 + i, "question": q, "question_id": 11 + i,
                 "feature_path": f"img{7 + i}.npy",
                 "answers": ["red"] * (8 - 3 * i) + ["blue"] * (2 + 3 * i)}
                for i, q in enumerate(["what color is the dog",
                                       "is it a cat"])]
        return case, {"annotations": _jsonl(root / f"{case}.jsonl", rows),
                      **feats, "processors": {
                          "text_processor": BERT,
                          "answer_processor": VQA_ANSWER,
                          "transformer_bbox_processor": {
                              "type": "transformer_bbox"}}}, "train"
    if case == "nlvr2":
        rows = [{"identifier": "dev-0-0-0", "sentence": "two dogs are sitting",
                 "label": "True"}]
        return case, {"annotations": _jsonl(root / "dev.jsonl", rows),
                      **feats, "processors": {"text_processor": BERT}}, "val"
    if case == "coco":
        rows = [{"image_id": 3, "caption_id": 9,
                 "caption_tokens": ["a", "dog"], "feature_path": "stale.npy",
                 "image_path": "COCO_cap1.jpg"}]
        return case, {"annotations": _jsonl(root / "cap.jsonl", rows),
                      **feats, "processors": {"text_processor": BERT}}, \
            "train"
    if case == "textvqa":
        return case, _ocr_cfg(root, case, [
            _textvqa_row(feature_path="stale/and/wrong.npy"),
            _textvqa_row(qid=78)]), "train"
    if case == "stvqa":
        return case, _ocr_cfg(root, case, [
            _textvqa_row(feature_path="img9.npy")]), "train"
    if case == "textcaps":
        row = _textvqa_row()
        del row["answers"], row["question"]
        row.update({"caption_id": 42, "caption_str": "stop sign",
                    "reference_strs": ["stop sign", "a red stop sign"],
                    "feature_path": "nope.npy", "question_str": "ignored"})
        return case, _ocr_cfg(root, case, [row], caption=True), "train"
    if case in ("ocrvqa", "vqa2_ocr"):
        row = _textvqa_row(feature_path="keepme.npy",
                           image_path="elsewhere/img.jpg")
        if case == "vqa2_ocr":
            row["question_id"] = None
        return case, _ocr_cfg(root, case, [row]), "train"
    if case == "visual_entailment":
        rows = [{"Flikr30kID": "1000092795.jpg", "gold_label": g,
                 "sentence2": "two dogs"} for g in ("neutral", "entailment")]
        return case, {"annotations": _jsonl(root / "ve.jsonl", rows),
                      **feats, "processors": {"text_processor": BERT}}, \
            "train"
    if case in ("hateful_memes", "hateful_memes_images"):
        cfg = {"annotations": _jsonl(root / "hm.jsonl", [
            {"id": "3456", "img": "img/03456.png",
             "text": "a movie about space", "label": 1}]),
            "processors": {"text_processor": BERT}}
        cfg.update({"images": str(root)} if case.endswith("images")
                   else feats)
        return "hateful_memes", cfg, "train"
    if case == "mmimdb":
        rows = [{"plot": ["a movie about space"], "genres": ["red", "blue"],
                 "feature_path": "m1.npy"}]
        return case, {"annotations": _jsonl(root / "mm.jsonl", rows),
                      **feats, "processors": {
                          "text_processor": BERT,
                          "answer_processor": {
                              "type": "multi_hot_answer_from_vocab",
                              "params": {"vocab": ["red", "blue", "dog"],
                                         "preprocessor": "simple_word"}}}}, \
            "train"
    if case == "clevr":
        return case, {"data_folder": str(root), "processors": {
            "text_processor": {
                "type": "vocab",
                "params": {"vocab": {"words": ["what", "color", "is",
                                               "the", "dog"]},
                           "max_length": 10}},
            "answer_processor": VQA_ANSWER}}, "train"
    if case == "visual_dialog":
        blob = {"split": "train",
                "data": {"questions": ["what color is the dog", "is it"],
                         "answers": ["red", "blue"],
                         "dialogs": [{"image_id": 901,
                                      "dialog": [{"question": k % 2,
                                                  "answer": k % 2}
                                                 for k in range(10)]}]}}
        (root / "visdial.json").write_text(json.dumps(blob))
        return case, {"annotations": str(root / "visdial.json"), **feats,
                      "processors": {"text_processor": BERT,
                                     "answer_processor": VQA_ANSWER}}, \
            "train"
    if case == "conceptual_captions":
        rows = [{"image_id": 4, "captions": ["a movie about space"],
                 "feature_path": "cc1.npy"}]
        return case, {"annotations": _jsonl(root / "cc.jsonl", rows),
                      **feats, "processors": {"text_processor": BERT}}, \
            "train"
    if case == "vqa_hat":
        rows = [{"question": "what color is the dog", "question_id": 12,
                 "image_id": 7, "image_name": "hat7",
                 "answers": ["red"] * 10}]
        return case, {"annotations": _jsonl(root / "hat.jsonl", rows),
                      "images": str(root), "processors": {
                          "text_processor": BERT,
                          "answer_processor": VQA_ANSWER}}, "train"
    # the masked pretraining datasets
    if case == "masked_coco":
        rows = [{"image_id": i,
                 "captions": ["a man rides a horse", "a man and a horse"],
                 "feature_path": f"img_{1 + i % 2}.npy"} for i in range(4)]
        return case, {"annotations": _imdb(root / "mcoco.npy", rows),
                      "features": str(root), "max_features": 4,
                      "use_image_feature_masks": True,
                      "processors": dict(MASKS), "seed": 11,
                      "two_sentence": True}, "train"
    if case == "masked_vqa2":
        rows = [{"image_id": 1, "question_id": 9,
                 "question_str": "what color is the sky",
                 "question_tokens": ["what", "color", "is", "the", "sky"],
                 "all_answers": ["blue"] * 10, "answers": ["blue"] * 10,
                 "feature_path": "img_1.npy"}] * 3
        return case, {"annotations": _imdb(root / "mvqa.npy", rows),
                      "features": str(root), "max_features": 4,
                      "processors": {**MASKS, "text_processor": BERT,
                                     "answer_processor": VQA_ANSWER},
                      "add_answer": True}, "train"
    if case == "masked_visual_genome":
        rows = [{"id": 77, "image_id": 2, "question": "what is the man riding",
                 "answers": ["the horse?"], "feature_path": "img_2.npy"}]
        return case, {"annotations": _imdb(root / "mvg.npy", rows),
                      "features": str(root), "max_features": 4,
                      "processors": {**MASKS, "text_processor": BERT,
                                     "answer_processor": VQA_ANSWER},
                      "add_answer": True}, "train"
    if case == "masked_q_vqa2":
        words = ["what", "color", "is", "the", "sky", "<mask>"]
        rows = [{"image_id": 1, "question_id": 9,
                 "question_str": "what color is the sky",
                 "question_tokens": words[:5], "answers": ["blue"] * 10,
                 "feature_path": "img_1.npy"}] * 3
        return case, {"annotations": _imdb(root / "mq.npy", rows),
                      "features": str(root), "max_features": 4, "seed": 2,
                      "processors": {
                          "text_processor": {
                              "type": "vocab",
                              "params": {"vocab": {"words": words},
                                         "max_length": 8}},
                          "answer_processor": {
                              "type": "vqa_answer",
                              "params": {"vocab": words,
                                         "num_answers": 10}}}}, "train"
    if case == "masked_mmimdb":
        rows = [{"image_id": 5, "plot": ["a man rides a horse"],
                 "genres": ["western", "space"],
                 "feature_path": "img_5.npy"}] * 2
        return case, {"annotations": _imdb(root / "mmm.npy", rows),
                      "features": str(root), "max_features": 4,
                      "processors": {**MASKS, "text_processor": BERT}}, \
            "train"
    assert case == "masked_localized_narratives"
    rows = [{"image_id": 6, "caption": "two birds",
             "feature_path": "img_6.npy"}]
    masks = {"masked_token_processor": MASKS["masked_token_processor"]}
    return case, {"annotations": _imdb(root / "mln.npy", rows),
                  "features": str(root), "max_features": 4,
                  "processors": masks}, "train"


BUILDER_CASES = [
    "vqa2", "gqa", "okvqa", "nlvr2", "coco", "textvqa", "stvqa", "textcaps",
    "ocrvqa", "vqa2_ocr", "visual_entailment", "hateful_memes",
    "hateful_memes_images", "mmimdb", "clevr", "visual_dialog",
    "conceptual_captions", "vqa_hat", "masked_coco", "masked_vqa2",
    "masked_visual_genome", "masked_q_vqa2", "masked_mmimdb",
    "masked_localized_narratives"]


@pytest.mark.parametrize("case", BUILDER_CASES)
def test_builder_items_and_batches(root, case):
    """The registered builder on both sides from one config: every item
    (read twice, so the seeded masks advance the same way) and the
    collated batch of all items are equal."""
    name, cfg, split = builder_case(root, case)
    jds = jregistry.get("builder", name)().load(cfg, split)
    tds = registry.get("builder", name)().load(cfg, split)
    assert len(tds) == len(jds) > 0
    for _ in range(2):
        jitems = [jds[i] for i in range(len(jds))]
        titems = [tds[i] for i in range(len(tds))]
        same(jitems, titems)
    if case.endswith("images") or case in ("vqa_hat", "nlvr2"):
        return   # images / nested samples: no single batch layout
    same(dict(JS.collate(jitems)), dict(TS.collate(titems)), "batch")


def test_every_jax_builder_name_and_phoc(root):
    assert set(registry.list("builder")) == set(jregistry.list("builder"))
    name, cfg, split = builder_case(root, "textvqa")
    cfg["processors"]["phoc_processor"] = {"type": "phoc",
                                           "params": {"max_length": 8}}
    with pytest.raises(NotImplementedError, match="phoc"):
        registry.get("builder", name)().load(cfg, split)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------

def processor_case(root, name):
    """(config, inputs) of one processor; each input is called in order
    on a fresh processor per side."""
    text = {"tokenizer_config": {"vocab": VOCAB_D}, "max_seq_length": 12}
    words = {"words": ["what", "color", "is", "the", "dog", "red"]}
    if name == "simple_word":
        return {}, [{"text": "It's a Dog?"}]
    if name == "simple_sentence":
        return {}, [{"text": "What's the, dog? A cat!"}]
    if name in ("vqa_answer", "multi_hot_answer_from_vocab"):
        return VQA_ANSWER["params"], [
            {"answers": ["Red", "red", "blue", "green"]},
            {"answer_tokens": ["red"] * 4 + ["sky"] * 6}]
    if name == "soft_copy_answer":
        return {**VQA_ANSWER["params"], "max_length": 5,
                "context_preprocessor": {"type": "simple_word"}}, [
            {"answers": ["stop"] * 4 + ["red"] * 6,
             "tokens": ["STOP", "sign", "red"]}]
    if name == "masked_token":
        return {**text, "mask_probability": 0.4, "seed": 3}, [
            {"text_a": "what color is the dog", "text_b": "a red dog"},
            {"text_a": "two dogs are sitting", "is_correct": 1},
            {"text_a": "the sign says stop " * 3, "text_b": "stop"}]
    if name == "bert_tokenizer":
        return text, [{"text": "What color is the dog?"},
                      {"tokens": ["two", "dogs"], "text_b": "sitting"},
                      {"text": ["a", "movie"]}]
    if name == "multi_sentence_bert_tokenizer":
        return text, [{"text": ["what color", "the dog"]},
                      {"text": "a single sentence"}]
    if name == "transformer_bbox":
        return {}, [{"bbox": np.random.RandomState(1).rand(5, 4) * 300,
                     "image_width": 640, "image_height": 480}]
    if name == "vocab":
        return {"vocab": words, "max_length": 6,
                "preprocessor": {"type": "simple_sentence"}}, [
            {"text": "What color is the cat?"}, {"tokens": ["red"] * 9}]
    if name == "glove":
        return {"vocab": {**words, "embedding_file": str(root / "ft.txt")},
                "max_length": 4}, [{"tokens": ["red", "stop", "dog"]}]
    if name == "fasttext":
        return {"model_file": str(root / "ft.txt"), "max_length": 4}, [
            {"tokens": ["sign", "zzz", "go"]}]
    if name == "bbox":
        info = [{"bounding_box": {"top_left_x": 0.1 * i, "top_left_y": 0.2,
                                  "width": 0.3, "height": 0.4}}
                for i in range(3)]
        return {"max_length": 5}, [{"info": info}]
    if name == "caption":
        return {"vocab": words}, [[1, 4, 5, 6, 2, 7], [4, 0, 0]]
    if name == "evalai_answer":   # the one processor built without config
        return None, ["Two, dogs?", "it's 3.50 dollars", "an apple; a day"]
    if name == "copy":
        return {"max_length": 6}, [{"blob": np.arange(8).reshape(4, 2)}]
    if name in ("m4c_answer", "m4c_caption"):
        n = 1 if name == "m4c_caption" else 10
        return {"vocab": ["<pad>", "<s>", "</s>", "<unk>", "red", "stop",
                          "sign"],
                "preprocessor": {"type": "simple_word"}, "num_answers": n,
                "max_length": 6, "max_copy_steps": 4, "seed": 4}, [
            {"answers": (["stop sign"] * 6 + ["red"] * 4)[:n],
             "tokens": ["stop", "sign", "stop"]},
            {"answers": (["red sign"] * 5 + ["go"] * 5)[:n],
             "tokens": ["sign"]}]
    if name == "masked_region":
        return {"mask_probability": 0.5, "seed": 5}, [
            np.random.RandomState(2).rand(9, 3).astype(np.float32)]
    if name == "multi_class_from_file":
        return {"vocab": ["neg", "pos"]}, [{"label": "pos"}, "neg"]
    if name == "GrayScaleTo3Channels":
        return {}, [np.ones((1, 2, 3), np.float32),
                    {"image": np.zeros((3, 2, 2), np.float32)}]
    if name == "prediction.argmax":
        return {"id_key": "question_id"}, [
            {"scores": np.random.RandomState(3).randn(4, 6), "id": [5, 6, 7,
                                                                     8]}]
    assert name == "torchvision_transforms"
    return {"transforms": [
        "ToTensor", {"type": "CenterCrop", "params": {"size": 10}},
        {"type": "Normalize", "params": {"mean": [0.5] * 3,
                                         "std": [0.25] * 3}},
        "GrayScaleTo3Channels"]}, [
        np.random.RandomState(6).randint(0, 256, (3, 12, 14)).astype(
            np.uint8)]


PROCESSORS = sorted(set(jregistry.list("processor")) - {"phoc"})


@pytest.mark.parametrize("name", PROCESSORS)
def test_processor_parity(root, name):
    """Each registered processor on the same inputs, in the same order
    (the RNG-drawing ones advance their seeded RandomState alike): equal
    outputs, and equal inputs after the call (``masked_region`` zeroes
    rows in place)."""
    cfg, inputs = processor_case(root, name)
    args = () if cfg is None else (cfg,)
    jp = jregistry.get("processor", name)(*args)
    tp = registry.get("processor", name)(*args)
    for item in inputs:
        ji = item.copy() if isinstance(item, (dict, np.ndarray)) else item
        ti = item.copy() if isinstance(item, (dict, np.ndarray)) else item
        same(jp(ji), tp(ti), name)
        same(ji, ti, f"{name} input")


def test_torchvision_resize_through_ops_image():
    """``Resize`` (shortest edge and fixed size) through the port's
    ``ops/image`` against ``jax.image.resize``: atol 1e-4."""
    x = np.random.RandomState(7).rand(3, 20, 28).astype(np.float32)
    for size in (12, [10, 16]):
        cfg = {"transforms": [{"type": "Resize", "params": {"size": size}}]}
        want = jregistry.get("processor", "torchvision_transforms")(cfg)(x)
        got = registry.get("processor", "torchvision_transforms")(cfg)(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_processor_wrapper_and_vocab(root):
    from transformer_mm_explainability_tpu_torch.data import processors as TPR

    p = TPR.Processor({"type": "simple_word", "params": {}})
    assert p({"text": "A Dog?"}) == JPR.Processor(
        {"type": "simple_word", "params": {}})({"text": "A Dog?"})
    with pytest.raises(AttributeError):
        TPR.Processor({"params": {}})
    v = TPR.Vocab(words=["red", "dog"], embedding_file=str(root / "ft.txt"))
    w = JPR.Vocab(words=["red", "dog"], embedding_file=str(root / "ft.txt"))
    assert v.itos == w.itos and v.get_embedding_dim() == 4
    np.testing.assert_array_equal(v.vectors, w.vectors)


# ---------------------------------------------------------------------------
# databases
# ---------------------------------------------------------------------------

def test_feature_readers(root, tmp_path):
    for reader_args, name in (((10,), "img7"), ((4,), "img8")):
        want = JD.PaddedFrcnnFeatureReader(*reader_args).read(
            str(root / f"{name}.npy"))
        got = TD.PaddedFrcnnFeatureReader(*reader_args).read(
            str(root / f"{name}.npy"))
        same(want, got)
    grid = np.random.RandomState(1).randn(1, 7, 7, 16).astype(np.float32)
    np.save(tmp_path / "grid.npy", grid)
    same(JD.PaddedFrcnnFeatureReader(49).read(str(tmp_path / "grid.npy")),
         TD.PaddedFrcnnFeatureReader(49).read(str(tmp_path / "grid.npy")))
    # raw npy (max_features None), and a .pt store read with
    # weights_only (the port's addition): the same array as the npy
    same(JD.FeatureReader(str(root), None).read("img7.npy"),
         TD.FeatureReader(str(root), None).read("img7.npy"))
    torch.save(torch.from_numpy(np.load(root / "img7.npy")),
               tmp_path / "img7.pt")
    feat, _ = TD.FeatureReader(str(tmp_path), 10).read("img7.pt")
    np.testing.assert_array_equal(
        feat, TD.FeatureReader(str(root), 10).read("img7.npy")[0])
    assert TD.FeatureReader(str(root), 10).read("img7.txt") is None
    (tmp_path / "store.lmdb").mkdir()
    reader = TD.FeatureReader(str(tmp_path / "store.lmdb"), None)
    with pytest.raises(ImportError, match="lmdb"):
        reader.read("x.npy")


def test_annotation_and_features_databases(root, tmp_path):
    rows = [{"image_id": 7, "question": "what color is the dog",
             "question_id": 11, "feature_path": "img7.npy",
             "answers": ["red"] * 10},
            {"image_id": 1, "valid_answers": ["red", "blue"]},
            {"image_id": 2, "all_answers": ["cat", "<copy>"],
             "image_name": "img8.jpg"}]
    paths = [_jsonl(tmp_path / "a.jsonl", rows),
             _imdb(tmp_path / "imdb.npy", rows)]
    (tmp_path / "a.json").write_text(json.dumps({"metadata": {"v": 2},
                                                 "data": rows}))
    paths.append(str(tmp_path / "a.json"))
    np.save(tmp_path / "d.npy", np.array({"metadata": {"v": 3},
                                          "data": rows}, dtype=object))
    paths.append(str(tmp_path / "d.npy"))
    for path in paths:
        jdb, tdb = JD.AnnotationDatabase(path), TD.AnnotationDatabase(path)
        assert len(tdb) == len(jdb) == 3 and tdb.metadata == jdb.metadata
        same([jdb[i] for i in range(3)], [tdb[i] for i in range(3)])
    jdb, tdb = JD.AnnotationDatabase(paths[0]), TD.AnnotationDatabase(
        paths[0])
    jf = JD.FeaturesDatabase(f"{root},{root}", annotation_db=jdb,
                             max_features=10)
    tf = TD.FeaturesDatabase(f"{root},{root}", annotation_db=tdb,
                             max_features=10)
    same([jf[0], jf[2]], [tf[0], tf[2]])
    # visual-genome stores: "<prefix>_<imageid>.npy" → "<imageid>.npy"
    _features(tmp_path, "8", seed=3)
    same(JD.FeaturesDatabase(str(tmp_path)).from_path("genome_img_8.npy"),
         TD.FeaturesDatabase(str(tmp_path)).from_path("genome_img_8.npy"))


def test_image_database(root):
    rows = [{"img": "img/03456.png"}, {"image_name": "hat7.png"},
            {"identifier": "hat7", "left_url": "l", "right_url": "r"}]
    for key in (None, "img"):
        jdb = JD.ImageDatabase(str(root), image_key=key)
        tdb = TD.ImageDatabase(str(root), image_key=key)
        for row in rows[:1] if key else rows[:2]:
            same(jdb.get(row), tdb.get(row))
    assert TD.ImageDatabase(str(root))._get_attrs(rows[2]) == \
        JD.ImageDatabase(str(root))._get_attrs(rows[2])
    with pytest.raises(RuntimeError):
        TD.ImageDatabase(str(root)).from_path("nope.jpg")


# ---------------------------------------------------------------------------
# multi-dataset loader, text decoders, LXMERT answers and pretraining data
# ---------------------------------------------------------------------------

def _loader(name, n, bs=2):
    def make():
        return iter([{"name": name, "i": i} for i in range(0, n, bs)])
    return make


@pytest.mark.parametrize("kw", [
    {"lengths": {"a": 80, "b": 40}, "seed": 3},
    {"proportional_sampling": False, "seed": 0},
    {"lengths": {"a": 4}, "seed": 0},
    {"lengths": {"a": 4, "b": 0}, "seed": 1},
])
def test_multi_dataset_loader(kw):
    loaders = {"a": _loader("a", 8), "b": _loader("b", 4)}
    jm, tm = JMD.MultiDatasetLoader(loaders, **kw), TMD.MultiDatasetLoader(
        loaders, **kw)
    assert tm.names == jm.names and tm.probabilities == jm.probabilities
    jseq, tseq = [], []
    for seq, mdl in ((jseq, jm), (tseq, tm)):
        for k, got in enumerate(mdl):
            seq.append(got)
            if k >= 29:
                break
    assert tseq == jseq and len(tseq) > 2


class _FixedModel:
    """Scores depend only on the previous token."""

    def __init__(self, table):
        self.table = np.asarray(table, np.float32)

    def scores(self, tokens):
        return self.table[tokens]


def _vocab(mod, n):
    v = mod.VocabFromText([], only_unk_extra=False)
    v.itos = ["<pad>", "<unk>", "<s>", "</s>"] + [f"w{i}" for i in
                                                  range(4, n)]
    v.stoi = {w: i for i, w in enumerate(v.itos)}
    v.PAD_INDEX, v.UNK_INDEX, v.SOS_INDEX, v.EOS_INDEX = 0, 1, 2, 3
    return v


def _decode(decoder, model, feats, max_steps=6):
    feats = decoder.init_batch(feats)
    data = {"texts": np.full((feats.shape[0], 1), 2, np.int64),
            "state": {"h": (np.arange(feats.shape[0], dtype=np.float32),
                            [np.zeros((feats.shape[0], 2), np.float32)])}}
    states = []
    for t in range(max_steps):
        finished, data, n = decoder.decode(
            t, data, model.scores(data["texts"][:, 0]))
        states.append((finished, n, data["texts"].copy(), data["state"]))
        if finished:
            break
    return decoder.get_result(), states


@pytest.mark.parametrize("decoder", ["beam_search", "nucleus_sampling"])
def test_text_decoders(decoder):
    """Beam search over two examples and nucleus sampling from one seeded
    RandomState: the same sequences, texts and re-indexed state at every
    step."""
    table = np.random.RandomState(7).randn(9, 9).astype(np.float32) * 2
    table[:, 3] += 1.0
    runs = []
    for mod in (JT, TT):
        if decoder == "beam_search":
            dec = mod.BeamSearch(_vocab(mod, 9), beam_length=4)
            feats = np.zeros((2, 2, 3), np.float32)
        else:
            dec = mod.NucleusSampling(_vocab(mod, 9), sum_threshold=0.8,
                                      rng=np.random.RandomState(0))
            feats = np.zeros((1, 2, 3), np.float32)
        runs.append(_decode(dec, _FixedModel(table), feats))
    same(runs[0][0], runs[1][0], "result")
    same(runs[0][1], runs[1][1], "steps")
    assert registry.get("decoder", decoder) is getattr(
        TT, {"beam_search": "BeamSearch",
             "nucleus_sampling": "NucleusSampling"}[decoder])


def test_ngrams_and_vocab_from_text():
    toks = ["a", "b", "c", "d"]
    assert TT.generate_ngrams(toks, 2) == JT.generate_ngrams(toks, 2)
    assert TT.generate_ngrams_range(toks, (1, 3)) == \
        JT.generate_ngrams_range(toks, (1, 3))
    for kw in ({"min_count": 2}, {"only_unk_extra": True},
               {"keep": ["cat"], "remove": ["the"]}):
        texts = ["the cat sat", "the cat ran", "dog"]
        t, j = TT.VocabFromText(texts, **kw), JT.VocabFromText(texts, **kw)
        assert t.itos == j.itos and t.stoi == j.stoi


ENTRIES = [{"ans": "man", "dsets": ["vqa", "gqa"]},
           {"ans": "gray", "dsets": ["vqa"]},
           {"ans": "2", "dsets": ["gqa"]},
           {"ans": "cat", "dsets": ["vqa", "visual7w"]}]


def test_answer_table_and_qa_head(tmp_path):
    (tmp_path / "all_ans.json").write_text(json.dumps(ENTRIES))
    for kw in ({"entries": ENTRIES}, {"dsets": ["gqa"], "entries": ENTRIES},
               {"all_ans_path": str(tmp_path / "all_ans.json")}):
        t, j = TQ.AnswerTable(**kw), JQ.AnswerTable(**kw)
        assert t.all_answers() == j.all_answers()
        assert t.ans2id_map() == j.ans2id_map()
    for ans in ["A man.", "the woman", "Grey", "one", "an apple", "THE CAT",
                "", "ten"]:
        assert TQ.convert_ans(ans) == JQ.convert_ans(ans)
    rs = np.random.RandomState(8)
    w, b = rs.randn(4, 6).astype(np.float32), rs.randn(4).astype(np.float32)
    label2ans = ["the man", "grey", "zebra", "Two", "cat."]
    same(JQ.load_lxmert_qa_head(w, b, JQ.AnswerTable(entries=ENTRIES),
                                label2ans),
         TQ.load_lxmert_qa_head(w, b, TQ.AnswerTable(entries=ENTRIES),
                                label2ans))


def _raw_data():
    return [
        {"img_id": "i1",
         "sentf": {"mscoco": ["a man standing", "someone here"],
                   "vqa": ["who is it?"]},
         "labelf": {"vqa": [{"the man": 0.9, "zebra": 0.3}]}},
        {"img_id": "i2", "sentf": {"vqa": ["how many cats?"]},
         "labelf": {"vqa": [{"two": 1.0}]}},
        {"img_id": "i3", "sentf": {"gqa": ["is it gray?", "what is it?"]},
         "labelf": {"gqa": [{"grey": 1.0}, {"cat": 0.5}]}},
        {"img_id": "missing", "sentf": {"vqa": ["unused"]},
         "labelf": {"vqa": [{"cat": 1.0}]}},
    ]


def _img_data():
    rs = np.random.RandomState(9)
    return [{"img_id": i, "img_h": 10, "img_w": 20, "num_boxes": 3,
             "features": rs.rand(3, 8).astype(np.float32),
             "boxes": np.array([[0, 0, 10, 5], [5, 2, 20, 10],
                                [1, 1, 2, 2]], np.float32),
             "objects_id": rs.randint(0, 9, 3),
             "objects_conf": rs.rand(3).astype(np.float32),
             "attrs_id": rs.randint(0, 9, 3),
             "attrs_conf": rs.rand(3).astype(np.float32)}
            for i in ("i1", "i2", "i3")]


def test_lxmert_pretrain_data(tmp_path):
    """LXMERTDataset (from files too), LXMERTPretrainData with and without
    the matched-task swap (the same seeded draws), LXMERTEvaluator."""
    (tmp_path / "all_ans.json").write_text(json.dumps(ENTRIES))
    (tmp_path / "part.json").write_text(json.dumps(_raw_data()[:2]))
    (tmp_path / "rest.json").write_text(json.dumps(_raw_data()[2:]))
    jds = JP.LXMERTDataset("part,rest", data_root=str(tmp_path))
    tds = TP.LXMERTDataset("part,rest", data_root=str(tmp_path))
    same(jds.data, tds.data)
    for matched in (False, True):
        jp = JP.LXMERTPretrainData(jds, _img_data(), task_matched=matched,
                                   seed=3)
        tp = TP.LXMERTPretrainData(tds, _img_data(), task_matched=matched,
                                   seed=3)
        assert len(tp) == len(jp) == 6
        for _ in range(3):
            same([jp[i] for i in range(len(jp))],
                 [tp[i] for i in range(len(tp))])
            same(jp.random_feat(), tp.random_feat())
    uid2ans = {"i1_vqa_000": "man", "i2_vqa_000": "7", "i3_gqa_001": "cat",
               "nonexistent": "cat"}
    assert TP.LXMERTEvaluator(tds).evaluate(uid2ans) == \
        JP.LXMERTEvaluator(jds).evaluate(uid2ans)
    assert TP.make_uid("i1", "vqa", 2) == JP.make_uid("i1", "vqa", 2)
