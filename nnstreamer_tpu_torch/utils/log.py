"""Structured logging with element provenance.

Counterpart of the JAX package's ``utils/log.py`` (parity target: the
reference's ``ml_logi/logw/loge/logf``, with a Python traceback where the
reference attaches a glibc ``backtrace()``).  The logger is
``nnstreamer_tpu_torch``.

``NNS_TPU_TORCH_LOG_JSON=1`` switches the handler to JSON lines (one
object per line: ``ts``, ``level``, ``logger``, ``element``, ``msg``), so
log rows join the metrics registry's samples on the shared ``element``
label; ``NNS_TPU_TORCH_LOG_LEVEL`` sets the level (default WARNING).
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback

from .conf import ENV_PREFIX

LOGGER_NAME = "nnstreamer_tpu_torch"
_LOGGER = logging.getLogger(LOGGER_NAME)

#: marker attribute on the handlers this module installed: configure()
#: dedups on it, so a second configure never stacks a second handler while
#: an application's own handlers on the same logger are left alone
_HANDLER_TAG = "_nns_tpu_torch_handler"


class JsonLineFormatter(logging.Formatter):
    """One JSON object per record; ``element`` carries the label the
    metrics registry uses."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "logger": record.name,
            "element": getattr(record, "element", "-"),
            "msg": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, sort_keys=True)


def _make_handler() -> logging.Handler:
    h = logging.StreamHandler()
    if os.environ.get(f"{ENV_PREFIX}LOG_JSON", "") == "1":
        h.setFormatter(JsonLineFormatter())
    else:
        h.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname).1s {LOGGER_NAME}[%(element)s] "
            "%(message)s", defaults={"element": "-"}))
    setattr(h, _HANDLER_TAG, True)
    return h


def configure(force: bool = False) -> None:
    """Idempotent handler setup.  A re-import runs this again on the same
    process-wide logger, so the dedup keys on the handler tag, not on
    module state.  A logger the application configured first is left as
    it is; ``force`` replaces our handler anyway (and picks up a changed
    ``NNS_TPU_TORCH_LOG_JSON``)."""
    ours = [h for h in _LOGGER.handlers if getattr(h, _HANDLER_TAG, False)]
    if ours and not force:
        return
    if not ours and _LOGGER.handlers and not force:
        return
    for h in ours:
        _LOGGER.removeHandler(h)
    _LOGGER.addHandler(_make_handler())
    _LOGGER.setLevel(os.environ.get(f"{ENV_PREFIX}LOG_LEVEL",
                                    "WARNING").upper())


configure()


def _log(level: int, msg: str, *args, element: str = "-") -> None:
    _LOGGER.log(level, msg, *args, extra={"element": element})


def logd(msg, *args, element="-"):
    _log(logging.DEBUG, msg, *args, element=element)


def logi(msg, *args, element="-"):
    _log(logging.INFO, msg, *args, element=element)


def logw(msg, *args, element="-"):
    _log(logging.WARNING, msg, *args, element=element)


def loge(msg, *args, element="-"):
    _log(logging.ERROR, msg, *args, element=element)


def loge_stacktrace(msg, *args, element="-"):
    _log(logging.ERROR, msg + "\n" + "".join(traceback.format_stack()),
         *args, element=element)


def logf(msg, *args, element="-"):
    _log(logging.CRITICAL, msg, *args, element=element)
