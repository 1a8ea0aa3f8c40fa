"""The port against the original reference's own maps
(``tools/verify_parity`` of the port, fixture mode, on the CPU).

The fixtures (``data/assets/parity/*.npz``) hold maps that the original
PyTorch reference computed in its own process, with the manifest and seed
of the random weights it used. Every map of every family must meet two
bars:

  * the tool's rule (``_map_delta``: max|Δ| / max(1, max|ref|) < 1e-4,
    strictly absolute for ``scores``), as the JAX tool applies it;
  * the relative bar max|Δ| / max|ref| <= 1e-3 (``REL_TOL``), because the
    tool's rule says nothing about a map whose max is below 1e-4 (an
    all-zero map passes it): ViT ``relevancy`` (1.2e-5), CLIP
    ``image_relevance`` (4.6e-6), VisualBERT ``cls_per_token_score``
    (1.5e-6) and ``transformer_att`` (3.5e-8), LXMERT ``R_t_i`` (6.5e-5),
    ``transformer_att_R_t_i`` (4.8e-7) and ``attn_gradcam_*`` (<= 2.5e-6),
    DETR ``R_q_i`` (1.2e-7) and ``transformer_att`` (1.5e-9). DETR
    ``attn_gradcam`` is 0 everywhere in the fixture, so the port's map
    must be exactly 0.

Measured relative distances of the port in fp32 on the CPU: ViT 3.7e-7;
CLIP 7.9e-7 (image), 2.2e-11 (text); VisualBERT <= 5.0e-6 but
``transformer_att`` 9.1e-5 (the port in float64 sits 5.9e-5 from the
fixture, so most of it is the fixture's own fp32 rounding); LXMERT
<= 1.8e-5 (``transformer_att_R_t_i``), the rest <= 2e-6; DETR <= 9.5e-7.

The per-example LRP sums (``ops/lrp.example_sum``) matter only at B > 1,
which no fixture has: the fixture's example runs in a batch of two with a
second seeded example, and its row must still meet both bars.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.tools import verify_parity as vp

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "transformer_mm_explainability_tpu" / "data" / \
    "assets" / "parity"
# every map each family must carry (the JAX tool's method coverage)
MAPS = {
    "vit": {"relevancy"},
    "clip": {"image_relevance", "text_relevance"},
    "visual_bert": {"cls_per_token_score", "transformer_att", "partial_lrp",
                    "raw_attn", "rollout", "attn_gradcam", "scores"},
    "lxmert": ({"R_t_t", "R_t_i", "scores"}
               | {f"{m}_{s}" for m in ("transformer_att", "partial_lrp",
                                       "raw_attn", "rollout",
                                       "attn_gradcam")
                  for s in ("R_t_t", "R_t_i")}),
    "detr": {"R_q_i", "transformer_att", "partial_lrp", "raw_attn",
             "rollout", "attn_gradcam"},
}
LRP_MAPS = {"visual_bert": ("transformer_att", "partial_lrp"),
            "lxmert": ("transformer_att_R_t_t", "transformer_att_R_t_i",
                       "partial_lrp_R_t_t", "partial_lrp_R_t_i")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_bars(report, name):
    r = report[name]
    assert r["ok"], (name, r)
    assert r["rel"] <= vp.REL_TOL, (name, r)


@pytest.mark.parametrize("family", vp.FAMILIES)
def test_fixture_is_the_jax_packages_byte_for_byte(family):
    ours = pathlib.Path(vp.fixture_path(family)).read_bytes()
    assert ours == (JAX_FIXTURES / f"{family}.npz").read_bytes()


def test_random_state_dict_deterministic():
    man = {"a.weight": (3, 4), "b.bias": (4,)}
    sd1 = vp.random_state_dict(man, seed=7)
    sd2 = vp.random_state_dict(man, seed=7)
    for k in man:
        assert torch.equal(sd1[k], sd2[k])
    sd3 = vp.random_state_dict(man, seed=8)
    assert float((sd1["a.weight"] - sd3["a.weight"]).abs().max()) > 0


@pytest.mark.parametrize("name", ["scores", "relevancy"])
def test_map_delta_is_the_jax_tools_rule(name):
    from transformer_mm_explainability_tpu.tools import verify_parity as jvp

    rng = np.random.RandomState(3)
    for scale in (1e-6, 1.0, 40.0):
        ref = rng.randn(4, 7) * scale
        our = ref + rng.randn(4, 7) * 3e-5
        assert vp._map_delta(our, ref, name) == jvp._map_delta(our, ref,
                                                               name)


@pytest.mark.parametrize("family", vp.FAMILIES)
def test_fixture_family_meets_both_bars(family):
    rep = vp.verify_fixture(family, printer=lambda *a: None, device="cpu")
    assert set(rep) - {"ok"} == MAPS[family]
    assert rep["ok"]
    for name in MAPS[family]:
        _both_bars(rep, name)
        assert rep[name]["uninformative"] == (rep[name]["max_ref"] < vp.TOL)
    if family == "detr":
        # the fixture's GradCAM row is 0: the port's must be exactly 0
        assert rep["attn_gradcam"]["max_ref"] == 0.0
        assert rep["attn_gradcam"]["max_abs"] == 0.0


@pytest.mark.parametrize("family", vp.FAMILIES)
def test_fixture_family_in_float64_meets_the_tools_rule(family):
    """The port in float64 against the reference's fp32 maps: within the
    tool's rule on every map. How far each sits (``pytest -s`` prints the
    table) is how far the fixture's own fp32 rounding or a normalised
    chain's conditioning moves it from the exact map."""
    rep = vp.verify_fixture(family, device="cpu", dtype=torch.float64)
    assert set(rep) - {"ok"} == MAPS[family]
    assert rep["ok"]
    for name in MAPS[family]:
        assert rep[name]["ok"], (name, rep[name])
        assert np.isfinite(rep[name]["max_abs"]), name


@pytest.mark.parametrize("family", sorted(LRP_MAPS))
def test_lrp_maps_per_example_at_batch_two(family):
    """The fixture's example in a batch with a second seeded example (the
    same text length): its LRP rows still meet both bars against the
    reference's one-sample maps."""
    sd, ref = vp.fixture_state_dict(family)
    if family == "visual_bert":
        run, first, second = (vp._visual_bert_ours, vp._visual_bert_inputs(),
                              vp._visual_bert_inputs(seed=202))
        assert second[1].sum() == first[1].sum()
    else:
        run, first, second = (vp._lxmert_ours, vp._lxmert_inputs(),
                              vp._lxmert_inputs(seed=203))
    pair = tuple(np.concatenate([a, b]) for a, b in zip(first, second))
    both = run(sd, "cpu", torch.float32, inputs=pair)
    for name in LRP_MAPS[family]:
        assert both[name].shape[0] == 2
        rep = {name: vp.map_report(both[name][:1], ref[name], name)}
        _both_bars(rep, name)
        assert not np.array_equal(both[name][0], both[name][1]), name


def test_cli_verify_parity_parser():
    p = cli.build_parser()
    args = p.parse_args(["verify-parity", "--family", "clip"])
    assert (args.family, args.generate, args.weights, args.device) == (
        "clip", False, None, "cuda")
    args = p.parse_args(["verify-parity", "--family", "all", "--device",
                         "cpu", "--generate", "--reference", "ref"])
    assert (args.family, args.generate, args.reference) == ("all", True,
                                                             "ref")
    for bad in (["--family", "bert"], ["--family", "vit", "--device",
                                       "default"]):
        with pytest.raises(SystemExit):
            p.parse_args(["verify-parity", *bad])


def test_cli_verify_parity_exit_codes(tmp_path, monkeypatch):
    """0 when the maps meet the tool's rule, 1 when one misses it (a
    fixture whose map is moved by 1e-3), as the JAX tool's main."""
    out = tmp_path / "report.json"
    assert cli.main(["verify-parity", "--family", "vit", "--device", "cpu",
                     "--out", str(out)]) == 0
    rep = json.loads(out.read_text())["vit"]
    assert rep["ok"] and rep["relevancy"]["rel"] <= vp.REL_TOL

    z = dict(np.load(vp.fixture_path("vit")))
    z["map_relevancy"] = z["map_relevancy"] + np.float32(1e-3)
    np.savez(tmp_path / "vit.npz", **z)
    monkeypatch.setattr(vp, "FIXTURE_DIR", str(tmp_path))
    assert cli.main(["verify-parity", "--family", "vit", "--device",
                     "cpu"]) == 1


def _small_vit_manifest():
    """The timm ViT layout of ``_vit_manifest`` at width 64 and depth 2
    (the golden 224-pixel inputs fix only the patch grid)."""
    full = vp._vit_manifest()
    shrink = {768: 64, 2304: 192, 3072: 256}
    return {k: tuple(shrink.get(d, d) for d in shape)
            for k, shape in full.items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < 2}


def test_cli_weights_without_reference_gives_digests(tmp_path):
    path = tmp_path / "vit.pth"
    torch.save(vp.random_state_dict(_small_vit_manifest(), seed=3), path)
    out = tmp_path / "report.json"
    assert cli.main(["verify-parity", "--family", "vit", "--weights",
                     str(path), "--reference", str(tmp_path / "none"),
                     "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())["vit"]
    assert rep["ok"] is None
    assert rep["relevancy"]["shape"] == [1, 196]
    assert np.isfinite(rep["relevancy"]["abs_sum"])
    assert rep["relevancy"]["abs_sum"] > 0


def test_cli_generate_without_reference_exits_nonzero(tmp_path):
    missing = tmp_path / "no_checkout"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_mm_explainability_tpu_torch.cli",
         "verify-parity", "--family", "clip", "--generate", "--reference",
         str(missing), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert str(missing) in proc.stderr
    assert "Traceback" not in proc.stderr + proc.stdout
