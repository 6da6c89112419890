"""Control-plane protocol specs (port of ``horovod_tpu/analysis/protocol/``),
in part: :mod:`journal_spec`, the HA journal's pure state machine, which
``runner/journal.py`` executes, and :mod:`migration_spec`, KV-cache live
migration's, which ``serving/kv_cache.py`` and ``serving/migration.py``
execute. The lease spec comes with the fleet plane (ROADMAP item 14), the
``hvd-model`` checker with item 15.
"""

from . import journal_spec, migration_spec  # noqa: F401
