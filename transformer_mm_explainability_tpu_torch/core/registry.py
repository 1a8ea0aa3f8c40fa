"""Global string→object registry (MMF-registry equivalent).

The port's copy of ``transformer_mm_explainability_tpu/core/registry.py``
(mmf/common/registry.py:58-281): decorator registration for models,
datasets (builders), processors, metrics, losses, optimizers, schedulers,
trainers, explainers, plus a free-form state mapping. One generic
namespace machinery instead of MMF's dozen bespoke ``register_*`` methods.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    def __init__(self) -> None:
        self._namespaces: Dict[str, Dict[str, Any]] = {}
        self._state: Dict[str, Any] = {}

    # -- namespaced registration ------------------------------------------
    def register(self, namespace: str, name: str) -> Callable:
        def decorator(obj):
            ns = self._namespaces.setdefault(namespace, {})
            if name in ns and ns[name] is not obj:
                raise KeyError(
                    f"{name!r} already registered in {namespace!r}")
            ns[name] = obj
            return obj

        return decorator

    def get(self, namespace: str, name: str) -> Any:
        ns = self._namespaces.get(namespace, {})
        if name not in ns:
            known = ", ".join(sorted(ns)) or "<empty>"
            raise KeyError(
                f"{name!r} not found in registry namespace {namespace!r} "
                f"(known: {known})")
        return ns[name]

    def list(self, namespace: str) -> List[str]:
        return sorted(self._namespaces.get(namespace, {}))

    # -- convenience decorators (the MMF surface) -------------------------
    def register_model(self, name: str) -> Callable:
        return self.register("model", name)

    def register_builder(self, name: str) -> Callable:
        return self.register("builder", name)

    def register_processor(self, name: str) -> Callable:
        return self.register("processor", name)

    def register_metric(self, name: str) -> Callable:
        return self.register("metric", name)

    def register_loss(self, name: str) -> Callable:
        return self.register("loss", name)

    def register_optimizer(self, name: str) -> Callable:
        return self.register("optimizer", name)

    def register_scheduler(self, name: str) -> Callable:
        return self.register("scheduler", name)

    def register_trainer(self, name: str) -> Callable:
        return self.register("trainer", name)

    def register_explainer(self, name: str) -> Callable:
        return self.register("explainer", name)

    def register_encoder(self, name: str) -> Callable:
        return self.register("encoder", name)

    def register_transformer_backend(self, name: str) -> Callable:
        return self.register("transformer_backend", name)

    def register_decoder(self, name: str) -> Callable:
        return self.register("decoder", name)

    def register_fusion(self, name: str) -> Callable:
        return self.register("fusion", name)

    # -- free-form state (registry.register/get in MMF) -------------------
    def set_state(self, key: str, value: Any) -> None:
        self._state[key] = value

    def get_state(self, key: str, default: Any = None) -> Any:
        return self._state.get(key, default)


registry = Registry()
