"""Model-URI resolution: scheme resolvers and versioned references.

The port's copy of the JAX package's ``filters/modeluri.py`` (parity:
the reference's ``mlagent://model/<name>/<version>`` URIs, ml_agent.c):
a scheme→resolver table that ``tensor_filter`` consults before it opens
a model, with a built-in ``file://`` resolver.

Versioned references: a ``@<tag>`` suffix names one version of a model
(``file://models/vit.safetensors@v2``).  :func:`resolve_model_uri_versioned`
returns ``(model, tag)``, so a hot swap records which version went live
(``runtime/lifecycle.py``); a suffix whose base names nothing raises
:class:`ModelUriError`.  A checkpoint ROOT (a directory) with a tag names
one of its numbered step directories (``trainers/checkpoint.py``):
``ckpts/net@latest`` resolves to the newest step and its number.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, Tuple
from urllib.parse import urlparse

_lock = threading.Lock()
_resolvers: Dict[str, Callable[[str], Any]] = {}

#: version-tag grammar: word chars, dots and dashes after a final ``@``
_VERSION_RE = re.compile(r"^(?P<base>.+)@(?P<tag>[A-Za-z0-9._-]+)$")


class ModelUriError(ValueError):
    """A model URI/path that cannot resolve: bad scheme, missing target,
    or a version suffix naming nothing."""


def register_model_resolver(scheme: str,
                            fn: Callable[[str], Any]) -> None:
    """``fn(uri) -> model`` (a path or any model object the target
    framework accepts)."""
    with _lock:
        _resolvers[scheme.lower()] = fn


def unregister_model_resolver(scheme: str) -> None:
    with _lock:
        _resolvers.pop(scheme.lower(), None)


def split_model_version(model: Any) -> Tuple[Any, str]:
    """Split a trailing ``@<tag>`` off a string model reference:
    ``"models/net.pkl@v2"`` → ``("models/net.pkl", "v2")``.  A string
    naming an existing file as it is never splits; non-strings pass
    through untagged."""
    if not isinstance(model, str):
        return model, ""
    m = _VERSION_RE.match(model)
    if m is None or os.path.exists(model):
        return model, ""
    return m.group("base"), m.group("tag")


def _resolve_scheme(model: str) -> Any:
    scheme = urlparse(model).scheme.lower()
    with _lock:
        fn = _resolvers.get(scheme)
    if fn is None:
        raise KeyError(
            f"no model resolver for scheme {scheme!r} "
            f"(register one with register_model_resolver)")
    return fn(model)


def resolve_model_uri_versioned(model: Any) -> Tuple[Any, str]:
    """Resolve a (possibly versioned) model reference to ``(model,
    version-tag)``:

    - ``file://models/net.pkl@v2`` → ``("models/net.pkl", "v2")``; the
      file must exist;
    - ``ckpts/net@123`` / ``ckpts/net@latest`` → the step DIRECTORY under
      the checkpoint root and the concrete step as the tag;
    - untagged references resolve as :func:`resolve_model_uri` does,
      with tag ``""``;
    - a plain string whose ``@``-base names nothing on disk is a
      registered NAME and passes through untouched.

    A suffix that names nothing raises :class:`ModelUriError` carrying
    the suffix and its base."""
    if isinstance(model, (list, tuple)):
        return (type(model)(resolve_model_uri(m) for m in model)), ""
    if not isinstance(model, str):
        return model, ""
    scheme = "://" in model
    base, tag = split_model_version(model)
    if not scheme and tag and not os.path.exists(str(base)):
        return model, ""
    if scheme:
        base = _resolve_scheme(base)
    if not tag:
        return base, ""
    if isinstance(base, str) and os.path.isdir(base):
        # checkpoint root: the tag names a step directory
        from ..trainers.checkpoint import resolve_step_dir

        try:
            return resolve_step_dir(base, tag)
        except ValueError as e:
            raise ModelUriError(
                f"model {model!r}: version suffix @{tag} does not "
                f"resolve under checkpoint root {base!r}: {e}") from None
    if isinstance(base, str) and not os.path.exists(base):
        raise ModelUriError(
            f"model {model!r}: version suffix @{tag} was split off, "
            f"but {base!r} does not exist — versioned references need "
            f"the base file on disk")
    return base, tag


def resolve_model_uri(model: Any) -> Any:
    """Resolve scheme-qualified string models (per entry for a list);
    everything else passes through.  A ``@tag`` suffix resolves to its
    target with the tag dropped."""
    if isinstance(model, (list, tuple)):
        return type(model)(resolve_model_uri(m) for m in model)
    if not isinstance(model, str):
        return model
    if "://" not in model and split_model_version(model)[1] == "":
        return model
    return resolve_model_uri_versioned(model)[0]


def _file_resolver(uri: str) -> str:
    return urlparse(uri).path


register_model_resolver("file", _file_resolver)
