"""The registry's wiring: the MMF-style name → component zoo, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/zoo.py``. Importing it
registers the losses, metrics, processors, dataset builders, schedulers,
optimizers and encoders (by importing their modules), the 29 model names,
the 5 explainer names and the three trainers, as MMF's ``setup_imports``
does; ``core/env.setup_imports`` imports this module.

    from transformer_mm_explainability_tpu_torch.zoo import registry
    vb = registry.get("model", "visual_bert")
    runner_cls = registry.get("trainer", "mmf_pert")
"""

from transformer_mm_explainability_tpu_torch.core import losses  # noqa: F401  (registers losses)
from transformer_mm_explainability_tpu_torch.core import metrics  # noqa: F401  (registers metrics)
from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.data import builders  # noqa: F401  (registers builders)
from transformer_mm_explainability_tpu_torch.data import extra_builders  # noqa: F401  (registers the builder-zoo tail)
from transformer_mm_explainability_tpu_torch.data import masked_datasets  # noqa: F401  (registers masked_* builders)
from transformer_mm_explainability_tpu_torch.data import processors  # noqa: F401  (registers processors)
from transformer_mm_explainability_tpu_torch.explain import (
    clip as explain_clip,
    detr as explain_detr,
    lxmert as explain_lxmert,
    visual_bert as explain_visual_bert,
    vit as explain_vit,
)
from transformer_mm_explainability_tpu_torch.harness.pert_runner import (
    LxmertPerturbationRunner,
    VisualBertPerturbationRunner,
)
from transformer_mm_explainability_tpu_torch.models import encoders  # noqa: F401  (registers encoders)
from transformer_mm_explainability_tpu_torch.models import (
    clip,
    detr,
    frcnn,
    fusions,
    lxmert,
    lxmert_mmf,
    m4c,
    mmbt,
    mmf_bert,
    mmf_transformer,
    mmf_zoo,
    movie_mcan,
    vilbert,
    visual_bert,
    vit,
)
from transformer_mm_explainability_tpu_torch.train import schedulers  # noqa: F401  (registers schedulers and adam_w)
from transformer_mm_explainability_tpu_torch.train.trainer import Trainer

_MODELS = {
    "vit": vit,
    "clip": clip,
    "visual_bert": visual_bert,
    "lxmert": lxmert,
    "detr": detr,
    "frcnn": frcnn,
    # the MMF model zoo, under the reference's registry names (pythia.py:19,
    # lorra.py:7, ban.py:10, butd.py:9, cnn_lstm.py:20,
    # top_down_bottom_up.py:9)
    "pythia": mmf_zoo,
    "pythia_image_only": mmf_zoo,      # pythia.py:340
    "pythia_question_only": mmf_zoo,   # pythia.py:314
    "multihead": mmf_zoo,              # pythia.py:368 (PythiaMultiHead)
    "lxmert-old": lxmert_mmf,          # lxmert.py:633
    "lorra": mmf_zoo,
    "ban": mmf_zoo,
    "butd": mmf_zoo,
    "cnn_lstm": mmf_zoo,
    "top_down_bottom_up": mmf_zoo,
    "m4c": m4c,
    "m4c_captioner": m4c,              # m4c_captioner.py:6 (remove_unk_idx)
    "mmbt": mmbt,
    "concat_bert": fusions,
    "concat_bow": fusions,
    "late_fusion": fusions,
    "unimodal_text": fusions,
    "unimodal_image": fusions,
    "mmf_transformer": mmf_transformer,
    "vilbert": vilbert,
    "mmf_bert": mmf_bert,              # mmf_bert.py:19
    "movie_mcan": movie_mcan,          # movie_mcan.py:21
    "visual_dialog": mmf_zoo,          # visdial_multi_modal.py:7 (pythia + VisDialDiscriminator)
}
_EXPLAINERS = {
    "vit": explain_vit,
    "clip": explain_clip,
    "visual_bert": explain_visual_bert,
    "lxmert": explain_lxmert,
    "detr": explain_detr,
}

for _name, _mod in _MODELS.items():
    if _name not in registry.list("model"):
        registry.register("model", _name)(_mod)
for _name, _mod in _EXPLAINERS.items():
    if _name not in registry.list("explainer"):
        registry.register("explainer", _name)(_mod)
if "mmf" not in registry.list("trainer"):
    registry.register_trainer("mmf")(Trainer)
    # the reference's mmf_pert trainer is the mmf trainer with the
    # perturbation evaluation mixin; the perturbation runners play it here
    registry.register_trainer("mmf_pert")(VisualBertPerturbationRunner)
    registry.register_trainer("lxmert_pert")(LxmertPerturbationRunner)

__all__ = ["registry"]
