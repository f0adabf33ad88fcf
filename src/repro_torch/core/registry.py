"""Policy registry: every scheduling policy is a first-class, named object.

The paper's two solvers (Max-Accuracy §IV, Max-Utility §V) and the §VI.C
Offload/Local baselines register here with a declared parameter schema;
callers construct them by name through :class:`PolicySpec`:

    spec = PolicySpec("max_utility", {"alpha": 200.0})
    policy = spec.build()          # controller-ready plan_round callable
    spec2 = PolicySpec.from_json(spec.to_json())

Parameter validation is strict: an unknown parameter, a missing required one,
or a wrong type raises ``ValueError`` at spec-construction time.

This module imports no policy module at top level (they import us for the
decorator); ``_ensure_builtins`` pulls them in lazily on first lookup.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

__all__ = [
    "Param",
    "PolicyEntry",
    "PolicySpec",
    "available_policies",
    "get_policy",
    "register_policy",
]

_REQUIRED = object()  # sentinel: parameter has no default and must be given


@dataclass(frozen=True)
class Param:
    """One declared policy parameter: name, accepted types, default.

    ``default is _REQUIRED`` marks the parameter mandatory.  ``nullable``
    parameters accept ``None`` (the baselines' mode switch: ``alpha=None``
    means accuracy mode, a float means utility mode).
    """

    name: str
    types: tuple[type, ...]
    default: Any = _REQUIRED
    nullable: bool = False
    doc: str = ""

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED

    @staticmethod
    def number(
        name: str, default: Any = _REQUIRED, *, nullable: bool = False, doc: str = ""
    ) -> "Param":
        return Param(name, (float, int), default, nullable, doc)

    @staticmethod
    def integer(
        name: str, default: Any = _REQUIRED, *, nullable: bool = False, doc: str = ""
    ) -> "Param":
        return Param(name, (int,), default, nullable, doc)

    def check(self, policy: str, value: Any) -> Any:
        if value is None:
            if self.nullable:
                return None
            raise ValueError(
                f"policy {policy!r}: parameter {self.name!r} must not be None"
            )
        if not isinstance(value, self.types) or isinstance(value, bool):
            want = "/".join(t.__name__ for t in self.types)
            raise ValueError(
                f"policy {policy!r}: parameter {self.name!r} expects {want}, "
                f"got {type(value).__name__} ({value!r})"
            )
        return value


@dataclass(frozen=True)
class PolicyEntry:
    """A registered policy: the plan_round callable plus its parameter schema.

    ``workloads`` names the workload kinds the policy can plan for; every
    policy ported so far plans the paper's independent-frame ``classify``
    workload.
    """

    name: str
    fn: Callable[..., Any]
    params: tuple[Param, ...] = ()
    doc: str = ""
    workloads: tuple[str, ...] = ("classify",)

    def param(self, name: str) -> Param | None:
        for p in self.params:
            if p.name == name:
                return p
        return None

    def validate(self, given: Mapping[str, Any]) -> dict[str, Any]:
        """Return the full resolved kwargs dict, or raise ``ValueError``."""
        allowed = tuple(p.name for p in self.params)
        for k in given:
            if self.param(k) is None:
                raise ValueError(
                    f"policy {self.name!r} accepts no parameter {k!r}; "
                    f"allowed: {allowed or '(none)'}"
                )
        out: dict[str, Any] = {}
        for p in self.params:
            if p.name in given:
                out[p.name] = p.check(self.name, given[p.name])
            elif p.required:
                raise ValueError(
                    f"policy {self.name!r} requires parameter {p.name!r}"
                )
            else:
                out[p.name] = p.default
        return out


_REGISTRY: dict[str, PolicyEntry] = {}
_BUILTINS_LOADED = False


def register_policy(
    name: str,
    *,
    params: Sequence[Param] = (),
    doc: str = "",
    workloads: Sequence[str] = ("classify",),
) -> Callable:
    """Decorator: register ``fn`` as policy ``name`` with a parameter schema.

    ``fn`` must follow the plan-round contract:
    ``fn(models, stream, net, *, npu_free, **params) -> RoundPlan``.
    """

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY and _REGISTRY[name].fn is not fn:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = PolicyEntry(
            name=name,
            fn=fn,
            params=tuple(params),
            doc=doc or (fn.__doc__ or "").strip(),
            workloads=tuple(workloads),
        )
        return fn

    return deco


def _ensure_builtins() -> None:
    """Import every module that registers built-in policies (idempotent)."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from . import baselines, max_accuracy, max_utility  # noqa: F401


def get_policy(name: str) -> PolicyEntry:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered: {available_policies()}"
        ) from None


def available_policies() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


@dataclass(frozen=True)
class PolicySpec:
    """A named policy plus validated parameters — serializable and buildable.

    Construction validates eagerly and fills in defaults, so two specs that
    mean the same schedule compare equal even if one spelled out the
    defaults.
    """

    name: str
    params: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        entry = get_policy(self.name)
        object.__setattr__(self, "params", dict(entry.validate(self.params)))

    def __hash__(self) -> int:  # params is a dict; hash its canonical items
        return hash((self.name, tuple(sorted(self.params.items()))))

    @staticmethod
    def coerce(
        policy: "PolicySpec | str | None",
        *,
        policy_name: str = "max_accuracy",
        alpha: float | None = None,
    ) -> "PolicySpec":
        """A ready spec passes through, a bare name becomes a spec, and
        ``None`` folds the legacy ``policy_name``/``alpha`` pair into one."""
        if policy is None:
            params = {"alpha": alpha} if alpha is not None else {}
            return PolicySpec(policy_name, params)
        if isinstance(policy, str):
            return PolicySpec(policy)
        return policy

    def build(self):
        """Return a controller-ready policy callable (the round closure)."""
        entry = get_policy(self.name)
        kw = dict(self.params)

        def policy(models, stream, net, *, npu_free: float = 0.0):
            return entry.fn(models, stream, net, npu_free=npu_free, **kw)

        policy.spec = self  # type: ignore[attr-defined]  # for introspection
        return policy

    def to_json(self) -> dict[str, Any]:
        return {"name": self.name, "params": dict(self.params)}

    @staticmethod
    def from_json(data: Mapping[str, Any] | str) -> "PolicySpec":
        if isinstance(data, str):
            data = json.loads(data)
        if not isinstance(data, Mapping) or "name" not in data:
            raise ValueError(f"not a PolicySpec payload: {data!r}")
        return PolicySpec(str(data["name"]), dict(data.get("params") or {}))
