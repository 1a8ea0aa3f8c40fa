"""The port's caption metrics (``utils/caption_metrics``) and the two
caption tools (``tools/coco_caption_eval``, ``tools/textcaps_eval``)
against the JAX package's, on captions drawn from a seed: every corpus and
per-image score within 1e-12, the tools' metrics and printouts equal; and
two of the published formulas by hand."""

import json
import math

import numpy as np
import pytest

from transformer_mm_explainability_tpu.tools import coco_caption_eval as jcce
from transformer_mm_explainability_tpu.tools import textcaps_eval as jtce
from transformer_mm_explainability_tpu.utils import caption_metrics as jcm
from transformer_mm_explainability_tpu_torch.tools import (
    coco_caption_eval as tcce)
from transformer_mm_explainability_tpu_torch.tools import textcaps_eval as ttce
from transformer_mm_explainability_tpu_torch.utils import caption_metrics as tcm

WORDS = ["a", "the", "man", "dog", "cat", "rides", "horse", "on", "mat",
         "sits", "red", "two", "birds", "fly", "away", "is", "of", "in"]
PUNCT = ["", ",", ".", "!", "'s", " -", "..."]
TOL = 1e-12


def _caption(rng) -> str:
    n = rng.randint(1, 12)
    words = [WORDS[i] + PUNCT[rng.randint(len(PUNCT))] * (rng.rand() < 0.2)
             for i in rng.randint(0, len(WORDS), n)]
    return " ".join(w.capitalize() if rng.rand() < 0.1 else w for w in words)


def _corpus(seed, n_images=6):
    """({img: [refs]}, {img: [one candidate]}), PTB-tokenized, with
    candidates that copy part of a reference so n-grams overlap."""
    rng = np.random.RandomState(seed)
    gts, res = {}, {}
    for i in range(n_images):
        refs = [_caption(rng) for _ in range(rng.randint(1, 5))]
        cand = refs[0].split()
        cand = cand[:rng.randint(1, len(cand) + 1)] + _caption(rng).split()[:2]
        gts[i] = [tcm.ptb_tokenize(r) for r in refs]
        res[i] = [tcm.ptb_tokenize(" ".join(cand))]
    return gts, res


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=TOL)


def test_ptb_tokenize_matches_jax():
    rng = np.random.RandomState(0)
    texts = [_caption(rng) for _ in range(50)] + [
        "A man, riding; a horse!", "The dog's toy...", "  Hello   WORLD  ",
        "-LRB- x -RRB- `` quoted ''", ""]
    for t in texts:
        assert tcm.ptb_tokenize(t) == jcm.ptb_tokenize(t), t
    assert tcm.PUNCTUATIONS == jcm.PUNCTUATIONS


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scorer", ["bleu", "rouge", "cider"])
def test_scorers_match_jax(seed, scorer):
    gts, res = _corpus(seed)
    make = {"bleu": lambda m: m.BleuScorer(4), "rouge": lambda m: m.Rouge(),
            "cider": lambda m: m.CiderD()}[scorer]
    got = make(tcm).compute_score(gts, res)
    want = make(jcm).compute_score(gts, res)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_hand_computed_bleu_and_rouge():
    """Two of the published formulas: BLEU's brevity penalty with the
    closest reference length, ROUGE-L's beta = 1.2 F-measure."""
    corpus, _ = tcm.BleuScorer(2).compute_score(
        {0: ["the cat on the mat"]}, {0: ["the cat"]})
    bp = math.exp(1 - 5 / 2)
    # the smoothing constants (tiny 1e-15, small 1e-9) shift it by ~1e-9
    np.testing.assert_allclose(corpus, [bp, bp], rtol=1e-6)
    beta2 = 1.2 ** 2
    assert tcm.Rouge().calc_score(["a b"], ["a b c d"]) == pytest.approx(
        (1 + beta2) * 0.5 / (0.5 + beta2), rel=1e-12)
    _, scores = tcm.CiderD().compute_score({0: ["a b c"]}, {0: ["a b c"]})
    assert scores == [0.0]       # one image: log(N) = 0 zeroes every idf


@pytest.mark.parametrize("seed", [3, 4])
def test_calculate_metrics_and_per_image_match_jax(seed):
    """The harness end to end on raw captions, with annotations outside
    the scored subset (ignored on both sides)."""
    rng = np.random.RandomState(seed)
    gts = {"annotations": [{"image_id": i, "caption": _caption(rng)}
                           for i in range(8) for _ in range(3)]}
    res = {"annotations": [{"image_id": i, "caption": _caption(rng)}
                           for i in range(8)]}
    ids = [0, 2, 3, 5, 7]
    got, want = (m.calculate_metrics(ids, gts, res) for m in (tcm, jcm))
    assert list(got) == list(want) == ["Bleu_1", "Bleu_2", "Bleu_3",
                                       "Bleu_4", "ROUGE_L", "CIDEr"]
    _close(list(got.values()), list(want.values()))
    coco = {i: [a for a in gts["annotations"] if a["image_id"] == i]
            for i in ids}
    cres = {i: [a for a in res["annotations"] if a["image_id"] == i]
            for i in ids}
    te, je = tcm.COCOEvalCap(ids, coco, cres), jcm.COCOEvalCap(ids, coco, cres)
    te.evaluate()
    je.evaluate()
    assert te.skipped == je.skipped == ("METEOR", "SPICE")
    assert list(te.img_to_eval) == list(je.img_to_eval)
    for i in ids:
        assert list(te.img_to_eval[i]) == list(je.img_to_eval[i])
        _close([v for k, v in te.img_to_eval[i].items() if k != "image_id"],
               [v for k, v in je.img_to_eval[i].items() if k != "image_id"])


def _run(main, argv, capsys):
    metrics = main(argv)
    return metrics, capsys.readouterr().out


def test_textcaps_eval_cli_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(5)
    imdb = np.array([{"dataset_name": "textcaps"}] + [
        {"image_id": f"i{i % 4}", "caption_str": _caption(rng)}
        for i in range(12)], dtype=object)
    np.save(tmp_path / "imdb.npy", imdb)
    preds = [{"image_id": f"i{i}", "caption": _caption(rng)}
             for i in range(4)]
    (tmp_path / "pred.json").write_text(json.dumps(preds))
    argv = ["--pred_file", str(tmp_path / "pred.json"),
            "--annotation_file", str(tmp_path / "imdb.npy")]
    got, gout = _run(ttce.main, argv, capsys)
    want, wout = _run(jtce.main, argv, capsys)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    assert gout == wout and "Final model performance" in gout
    with pytest.raises(Exception, match="train and val"):
        ttce.main(argv + ["--set", "test"])


def test_coco_caption_eval_cli_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(6)
    ref = {"images": [
        {"split": "test" if i % 3 else "train", "sentences": [
            {"imgid": i, "raw": _caption(rng)} for _ in range(2)]}
        for i in range(9)]}
    preds = [{"image_id": i, "caption": _caption(rng)} for i in range(9)]
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    (tmp_path / "pred.json").write_text(json.dumps(preds))
    argv = ["--reference_json", str(tmp_path / "ref.json"),
            "--predicted_json", str(tmp_path / "pred.json")]
    assert tcce.references_from_karpathy_json(ref) == \
        jcce.references_from_karpathy_json(ref)
    got, gout = _run(tcce.main, argv, capsys)
    want, wout = _run(jcce.main, argv, capsys)
    assert list(got) == list(want)
    _close(list(got.values()), list(want.values()))
    assert gout.startswith("{'Bleu_1'") and wout.startswith("{'Bleu_1'")
