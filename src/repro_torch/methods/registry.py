"""Method registry: name -> gradient-estimation paradigm (counterpart of
``repro.methods.registry``)."""
from __future__ import annotations

from typing import Dict, Tuple

from .base import Method

_REGISTRY: Dict[str, Method] = {}


def register(name: str):
    """Class decorator: instantiate and register a Method under ``name``."""
    def deco(cls):
        method = cls()
        if method.name != name:
            raise ValueError(
                f"method class {cls.__name__} declares name "
                f"{method.name!r} but is registered as {name!r}")
        _REGISTRY[name] = method
        return cls
    return deco


def get(name: str) -> Method:
    """Resolve a method by its ``tcfg.optimizer`` name; unknown names raise
    ``ValueError`` listing :func:`available`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; available: "
            f"{', '.join(available())}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
