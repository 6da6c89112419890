"""Error-feedback residual store (port of
``horovod_tpu/compression/residual.py``).

Plain quantized SGD is biased: gradient components smaller than a block's
quantization step round to zero on every step and are lost. Error feedback
carries step t's quantization error into step t+1's input
(``compress(g + e)``; ``e' = (g + e) - decompress(compress(g + e))``).

Residuals are keyed by tensor name and reset whenever the elastic version
this process joined moves: a new cohort's chunks do not line up with the
old one's, so a residual never crosses cohorts. They live in float32 on
the gradient's device, one extra copy of each compressed tensor.
"""


from ..analysis import sanitizer
from ..utils import envparse
from ..utils.logging_util import get_logger


class ResidualStore:
    """name -> list of per-tensor residuals (aligned with the entry's
    tensors)."""

    def __init__(self):
        self._lock = sanitizer.make_lock("compression.residuals")
        self._store = {}
        self._version = self._current_version()
        self._log = get_logger()

    @staticmethod
    def _current_version():
        return envparse.get_str(envparse.ELASTIC_VERSION, "0")

    def _maybe_reset_locked(self):
        version = self._current_version()
        if version != self._version:
            dropped = len(self._store)
            self._store.clear()
            self._log.warning(
                "compression: residual store reset (elastic version "
                "%s -> %s, %d residual(s) dropped): error-feedback "
                "state never crosses cohorts", self._version, version,
                dropped)
            self._version = version

    def get(self, name):
        """Residual list for ``name``, or None (first occurrence)."""
        with self._lock:
            self._maybe_reset_locked()
            return self._store.get(name)

    def put(self, name, residuals):
        with self._lock:
            self._maybe_reset_locked()
            self._store[name] = list(residuals)

    def reset(self):
        with self._lock:
            self._store.clear()

    def __len__(self):
        with self._lock:
            return len(self._store)
