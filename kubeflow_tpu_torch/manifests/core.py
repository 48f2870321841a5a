"""The port's prototype registry; a copy of
``kubeflow_tpu/manifests/core.py`` (``ParamSpec``, ``prototype``,
``get_prototype``, ``all_prototypes``, ``generate``, ``gateway_route``).

A *prototype* is a registered function taking validated params and
returning a list of Kubernetes objects (plain dicts). The port's
prototypes live in this package (``serving.py``, ``training.py``) and
register on import; JAX's prototypes never load into this registry.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

DEFAULT_NAMESPACE = "kubeflow"

# The modules whose prototypes :func:`load_all_packages` registers.
PACKAGES = ("serving", "training")


class PrototypeError(Exception):
    pass


class _Required:
    def __repr__(self) -> str:  # pragma: no cover
        return "<required>"


REQUIRED = _Required()


@dataclass(frozen=True)
class ParamSpec:
    """One prototype parameter (@param/@optionalParam analogue)."""

    name: str
    default: Any = REQUIRED
    description: str = ""

    @property
    def required(self) -> bool:
        return self.default is REQUIRED


@dataclass
class Prototype:
    name: str
    description: str
    package: str
    params: tuple[ParamSpec, ...]
    fn: Callable[..., list[dict]]

    def resolve_params(self, overrides: Mapping[str, Any]) -> dict[str, Any]:
        known = {p.name: p for p in self.params}
        unknown = set(overrides) - set(known)
        if unknown:
            raise PrototypeError(
                f"prototype {self.name}: unknown params {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        resolved: dict[str, Any] = {}
        missing = []
        for p in self.params:
            if p.name in overrides:
                resolved[p.name] = overrides[p.name]
            elif p.required:
                missing.append(p.name)
            else:
                resolved[p.name] = p.default
        if missing:
            raise PrototypeError(
                f"prototype {self.name}: missing required params {missing}"
            )
        return resolved

    def generate(self, overrides: Mapping[str, Any] | None = None) -> list[dict]:
        objs = self.fn(**self.resolve_params(overrides or {}))
        for o in objs:
            if "apiVersion" not in o or "kind" not in o or "metadata" not in o:
                raise PrototypeError(
                    f"prototype {self.name} produced a non-k8s object: {o}"
                )
        return objs


_REGISTRY: dict[str, Prototype] = {}
_PACKAGES_LOADED = False


def prototype(
    name: str,
    description: str,
    params: Sequence[ParamSpec] = (),
    package: str = "",
) -> Callable[[Callable[..., list[dict]]], Callable[..., list[dict]]]:
    """Decorator registering a manifest-generator function as a prototype."""

    def _register(fn: Callable[..., list[dict]]) -> Callable[..., list[dict]]:
        if name in _REGISTRY:
            raise PrototypeError(f"duplicate prototype {name}")
        pkg = package or fn.__module__.rsplit(".", 1)[-1]
        _REGISTRY[name] = Prototype(
            name=name,
            description=description,
            package=pkg,
            params=tuple(params),
            fn=fn,
        )
        return fn

    return _register


def load_all_packages() -> None:
    """Import the port's prototype modules so their prototypes register."""
    global _PACKAGES_LOADED
    if _PACKAGES_LOADED:
        return
    for mod in PACKAGES:
        importlib.import_module(f"{__package__}.{mod}")
    _PACKAGES_LOADED = True


def get_prototype(name: str) -> Prototype:
    load_all_packages()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise PrototypeError(
            f"unknown prototype {name!r}; available: {sorted(_REGISTRY)}"
        )


def all_prototypes() -> dict[str, Prototype]:
    load_all_packages()
    return dict(_REGISTRY)


def generate(name: str, params: Mapping[str, Any] | None = None) -> list[dict]:
    """Instantiate a prototype (the `ks generate` + `ks show` analogue)."""
    return get_prototype(name).generate(params)


GATEWAY_ROUTE_ANNOTATION = "kubeflow-tpu.org/gateway-route"


def _dump_route(spec: dict) -> str:
    """The route spec as the gateway reads it: YAML as JAX's renderer
    writes it when PyYAML is importable, else JSON, which is YAML in flow
    style and parses to the same mapping (the GPU image need not carry
    PyYAML)."""
    try:
        import yaml
    except ImportError:
        return json.dumps(spec, sort_keys=True)
    return yaml.safe_dump(spec, sort_keys=True)


def gateway_route(name: str, prefix: str, service: str, rewrite: str = "/",
                  backends: list | None = None, shadow: str = "",
                  strategy: str = "", epsilon: float | None = None,
                  outlier: dict | None = None,
                  affinity_tokens: int | None = None,
                  pressure: int | None = None,
                  kv_pressure: float | None = None,
                  prefill_backends: list | None = None,
                  qos: dict | None = None,
                  splits: list | None = None,
                  shadow_fraction: float | None = None) -> dict:
    """Gateway route annotation for a Service: the gateway proxy discovers
    Services carrying it and routes ``prefix`` to them. ``backends``
    ([{service, weight}, ...]) splits traffic by weight; ``shadow``
    mirrors every request fire-and-forget; the rest are the prefix-affine
    pool's, QoS's and progressive delivery's knobs, as in JAX."""
    spec: dict = {"name": name, "prefix": prefix, "service": service,
                  "rewrite": rewrite}
    if backends:
        spec["backends"] = backends
    if shadow:
        spec["shadow"] = shadow
    if strategy:
        spec["strategy"] = strategy
    if epsilon is not None:
        spec["epsilon"] = epsilon
    if outlier:
        spec["outlier"] = outlier
    if affinity_tokens is not None:
        spec["affinity_tokens"] = int(affinity_tokens)
    if pressure is not None:
        spec["pressure"] = int(pressure)
    if kv_pressure is not None:
        spec["kv_pressure"] = float(kv_pressure)
    if prefill_backends:
        spec["prefill_backends"] = prefill_backends
    if qos:
        spec["qos"] = qos
    if splits:
        spec["splits"] = splits
    if shadow_fraction is not None:
        spec["shadow_fraction"] = float(shadow_fraction)
    return {GATEWAY_ROUTE_ANNOTATION: _dump_route(spec)}
