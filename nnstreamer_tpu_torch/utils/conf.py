"""Layered configuration (counterpart of the JAX package's ``utils/conf.py``).

Parity target: the reference's nnstreamer_conf.c:47-70 — environment
variables override an ini file, which overrides built-in defaults.

Layers (highest priority first):
1. environment: ``NNS_TPU_TORCH_<SECTION>_<KEY>`` (e.g.
   ``NNS_TPU_TORCH_COMMON_PLUGINS``);
2. the ini file at ``$NNS_TPU_TORCH_CONF_FILE``, else
   ``~/.config/nnstreamer_tpu_torch.ini``;
3. built-in defaults.

The sections and keys are the JAX package's: ``common.plugins`` (extra
element modules, ``runtime/registry.py``) and the
``filter.framework_priority_<ext>`` lists (``framework=auto``).  The
environment keys and the ini file are the port's own, so settings made
for the JAX package (``NNS_TPU_*``, whose plugins import JAX modules and
whose priorities name ``jax-xla``) leave the port unchanged.  The
defaults differ where the port runs other frameworks: model files that
the JAX package hands to ``jax-xla`` go to ``torch-cuda`` here, and
TorchScript files to ``pytorch``.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

_DEFAULTS: Dict[str, Dict[str, str]] = {
    "common": {
        "plugins": "",               # extra plugin modules, ':'-separated
        "enable_envvar": "true",
    },
    "filter": {
        # framework priority per model extension (parity:
        # framework_priority_tflite etc., nnstreamer.ini.in)
        "framework_priority_npz": "torch-cuda",
        "framework_priority_safetensors": "torch-cuda",
        "framework_priority_pkl": "torch-cuda",
        "framework_priority_pt": "pytorch",
        "framework_priority_pth": "pytorch",
        "framework_priority_py": "python3",
    },
}

_TRUE = ("1", "true", "yes", "on")
#: prefix of the port's environment keys (the JAX package's is NNS_TPU_)
ENV_PREFIX = "NNS_TPU_TORCH_"


class Conf:
    def __init__(self, path: Optional[str] = None):
        self._cp = configparser.ConfigParser()
        for sec, kv in _DEFAULTS.items():
            self._cp[sec] = dict(kv)
        path = path or os.environ.get(f"{ENV_PREFIX}CONF_FILE") or \
            os.path.expanduser("~/.config/nnstreamer_tpu_torch.ini")
        self.path = path
        if path and os.path.isfile(path):
            self._cp.read(path)

    def get(self, section: str, key: str, default: str = "") -> str:
        if self._env_enabled() or (section, key) == ("common",
                                                     "enable_envvar"):
            env = os.environ.get(
                f"{ENV_PREFIX}{section.upper()}_{key.upper()}")
            if env is not None:
                return env
        try:
            return self._cp.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return default

    def _env_enabled(self) -> bool:
        try:
            v = self._cp.get("common", "enable_envvar")
        except (configparser.NoSectionError, configparser.NoOptionError):
            v = "true"
        v = os.environ.get(f"{ENV_PREFIX}COMMON_ENABLE_ENVVAR", v)
        return v.strip().lower() in _TRUE

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get(section, key, "")
        if not v:
            return default
        return v.strip().lower() in _TRUE

    @property
    def extra_plugin_modules(self) -> List[str]:
        v = self.get("common", "plugins", "")
        return [m for m in v.split(":") if m.strip()]

    @property
    def element_restriction(self) -> Optional[List[str]]:
        v = self.get("element", "restriction", "")
        items = [m for m in v.split(":") if m.strip()]
        return items or None

    def framework_priority(self, ext: str) -> List[str]:
        v = self.get("filter", f"framework_priority_{ext.lstrip('.')}", "")
        return [m for m in v.split(",") if m.strip()]


_conf: Optional[Conf] = None
_conf_lock = threading.Lock()


def get_conf(reload: bool = False) -> Conf:
    global _conf
    with _conf_lock:
        if _conf is None or reload:
            _conf = Conf()
        return _conf
