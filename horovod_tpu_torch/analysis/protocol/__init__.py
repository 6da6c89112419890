"""Control-plane protocol specs (port of ``horovod_tpu/analysis/protocol/``),
in part: :mod:`journal_spec`, the HA journal's pure state machine, which
``runner/journal.py`` executes. The lease and migration specs come with the
fleet and serving planes (ROADMAP item 14), the ``hvd-model`` checker with
item 15.
"""

from . import journal_spec  # noqa: F401
