"""Builder helpers — MMF's ``mmf/utils/build.py`` surface (C21/C22), in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/core/build.py``
(``VisualBERT/mmf/utils/build.py``): build_config(:22),
build_trainer(:43), build_model(:61), build_dataset(:85),
build_dataloader_and_sampler(:126), build_optimizer(:203),
build_scheduler(:250), build_classifier_layer(:269),
build_text_encoder(:276), build_image_encoder(:286), build_encoder(:296),
build_processors(:320) — every constructor resolved through
``core.registry`` namespaces instead of MMF's omegaconf plumbing.

The "dataloader" is a host-side batch iterator producing collated numpy
batches (``SampleList.to_device`` moves one to the card); sharding over
processes replaces torch's DistributedSampler (each process slices
``index % num_shards == shard``). ``build_optimizer`` returns the
``train/steps.Recipe`` a registered optimizer name gives
(``train/schedulers``), ``build_scheduler`` the registered
``schedule(step) -> multiplier``.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.core.sample import collate


def build_config(configuration, **overrides) -> Any:
    """build.py:22-40: freeze + register the config cascade."""
    config = configuration.freeze() if hasattr(configuration, "freeze") \
        else configuration
    registry.set_state("config", config)
    registry.set_state("configuration", configuration)
    return config


def build_trainer(config: Dict[str, Any], **kwargs) -> Any:
    """build.py:43-58: resolve the registered trainer.  The Trainer takes
    its loss function, parameters and optimizer as arguments instead of
    a god-config, so pass those as kwargs to construct — with no kwargs
    the resolved class itself is returned."""
    trainer_type = config["training"]["trainer"] \
        if "training" in config else config.get("trainer", "mmf")
    trainer_cls = registry.get("trainer", trainer_type)
    return trainer_cls(**kwargs) if kwargs else trainer_cls


def build_model(config: Dict[str, Any]) -> Any:
    """build.py:61-82: resolve the registered model by
    ``config['model']`` — registry.get raises KeyError (listing the
    known names) for unregistered models.  Registered entries are model
    MODULES (init/forward function pairs), returned as-is; class-style
    entries are constructed with the config."""
    model = registry.get("model", config["model"])
    return model(config) if isinstance(model, type) else model


def build_dataset(dataset_key: str, config: Optional[Dict] = None,
                  dataset_type: str = "train") -> Any:
    """build.py:85-123."""
    builder_cls = registry.get("builder", dataset_key)
    assert builder_cls, (f"Key {dataset_key} doesn't have a registered "
                         "dataset builder")
    builder = builder_cls()
    return builder.load(config or {}, dataset_type)


def build_dataloader_and_sampler(
        dataset, training_config: Dict[str, Any]
) -> Tuple[Iterator, Optional[Any]]:
    """build.py:126-200 → a host-side batch iterator.

    Shuffles for train/val (not test) with a seeded RNG, slices every
    ``num_shards``-th index for this ``shard`` (the DistributedSampler
    equivalent under multi-process SPMD), collates with
    ``core.sample.collate``.  Returns (iterator-factory, None): call
    the factory per epoch.
    """
    import numpy as np

    batch_size = training_config.get("batch_size", 32)
    shard = training_config.get("shard", 0)
    num_shards = training_config.get("num_shards", 1)
    seed = training_config.get("seed", 0)
    dataset_type = getattr(dataset, "dataset_type", "train")
    shuffle = dataset_type != "test"

    def epoch_iter(epoch: int = 0):
        n = len(dataset)
        order = np.arange(n)
        if shuffle:
            np.random.RandomState(seed + epoch).shuffle(order)
        order = order[shard::num_shards]
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            yield collate([dataset[int(i)] for i in idxs])

    return epoch_iter, None


def build_optimizer(params, config: Dict[str, Any]):
    """build.py:203-247: the registered optimizer's ``train/steps.Recipe``
    (``recipe.init(params)`` makes the optimizer over a parameter
    tree)."""
    optimizer_config = config["optimizer"]
    if "type" not in optimizer_config:
        raise ValueError(
            "Optimizer attributes must have a 'type' key "
            "specifying the type of optimizer. (Custom or PyTorch)")
    opt_type = optimizer_config["type"]
    if "params" not in optimizer_config:
        warnings.warn(
            "optimizer attributes has no params defined, "
            "defaulting to {}.")
    opt_params = optimizer_config.get("params", {})
    opt_cls = registry.get("optimizer", opt_type)
    return opt_cls(**opt_params)


def build_scheduler(config: Dict[str, Any]):
    """build.py:250-266: schedule fn from the registry."""
    scheduler_config = config.get("scheduler", {})
    if "type" not in scheduler_config:
        warnings.warn(
            "No type for scheduler specified even though lr_scheduler "
            "is True, setting default to 'Pythia'")
    sched_type = scheduler_config.get("type", "pythia")
    if "params" not in scheduler_config:
        warnings.warn(
            "scheduler attributes has no params defined, "
            "defaulting to {}.")
    params = scheduler_config.get("params", {})
    return registry.get("scheduler", sched_type)(**params)


def build_classifier_layer(config: Dict[str, Any], in_dim: int,
                           out_dim: int, seed=0, device="cuda"):
    """build.py:269-273 over ClassifierLayer (layers.py:99-123): ``(params,
    fwd)`` of the requested classifier type, on ``device`` (cuda unless
    the caller asks for the CPU)."""
    import torch

    from transformer_mm_explainability_tpu_torch._device import (
        resolve_device)
    from transformer_mm_explainability_tpu_torch.models import (
        mmf_layers as L)

    device = resolve_device(device)
    ctype = config["type"]
    kw = config.get("params", {})
    if ctype == "weight_norm":
        return (L.init_weight_norm_classifier(seed, in_dim, out_dim,
                                              kw["hidden_dim"], device),
                L.weight_norm_classifier_fwd)
    if ctype == "logit":
        return (L.init_logit_classifier(seed, in_dim, out_dim, **kw,
                                        device=device),
                L.logit_classifier_fwd)
    if ctype == "mlp":
        return (L.init_mlp_classifier(seed, in_dim, out_dim, **kw,
                                      device=device),
                L.mlp_classifier_fwd)
    if ctype == "language_decoder":
        return (L.init_language_decoder(seed, in_dim, out_dim, **kw,
                                        device=device),
                L.language_decoder_fwd)
    if ctype == "triple_linear":
        gen = L.generator(seed)
        p = [L.init_linear(gen, in_dim, out_dim, device) for _ in range(3)]

        def triple_fwd(p, x):
            """TripleLinear (layers.py:674-691): a training input ``[B, 3,
            D]`` gives each branch's head ``[B, 3, A]``, an eval input
            ``[B, D]`` the first head's."""
            if x.dim() == 3:
                return torch.stack([L.linear_fwd(p[i], x[:, i])
                                    for i in range(3)], dim=1)
            return L.linear_fwd(p[0], x)

        return p, triple_fwd
    if ctype == "linear":
        return L.init_linear(seed, in_dim, out_dim, device), L.linear_fwd
    raise NotImplementedError("Unknown classifier type: %s" % ctype)


def build_text_encoder(config: Dict[str, Any]):
    """build.py:276-283."""
    from transformer_mm_explainability_tpu_torch.models import encoders as E
    return E.build_text_encoder(config["type"], config.get("params"))


def build_image_encoder(config: Dict[str, Any],
                        direct_features: bool = False):
    """build.py:286-293."""
    from transformer_mm_explainability_tpu_torch.models import encoders as E
    if direct_features:
        return E.build_image_feature_encoder(config["type"],
                                             config.get("params", {}))
    return E.build_image_encoder(config["type"], config.get("params"))


def build_encoder(config: Dict[str, Any]):
    """build.py:296-317: the registered encoder, from the {type, params}
    or the structured {name, ...} config form."""
    from transformer_mm_explainability_tpu_torch.models import (  # noqa: F401
        encoders)  # registers the encoders
    if "type" in config:
        name, params = config["type"], config.get("params", {})
    else:
        name, params = config["name"], config
    return registry.get("encoder", name)(params)


def build_processors(processors_config: Dict[str, Any],
                     registry_key: Optional[str] = None
                     ) -> Dict[str, Callable]:
    """build.py:320-358."""
    from transformer_mm_explainability_tpu_torch.data.processors import (
        Processor)

    processor_dict: Dict[str, Callable] = {}
    for processor_key, processor_params in processors_config.items():
        if not processor_params:
            continue
        instance = None
        if registry_key is not None:
            instance = registry.get_state(
                registry_key.format(processor_key))
        if instance is None:
            instance = Processor(processor_params)
        processor_dict[processor_key] = instance
    return processor_dict
