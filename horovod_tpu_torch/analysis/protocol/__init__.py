"""Control-plane protocol specs (port of ``horovod_tpu/analysis/protocol/``),
in part: :mod:`journal_spec`, the HA journal's pure state machine, which
``runner/journal.py`` executes; :mod:`migration_spec`, KV-cache live
migration's, which ``serving/kv_cache.py`` and ``serving/migration.py``
execute; and :mod:`lease_spec`, the fleet lease's, which
``fleet/ledger.py`` executes. The ``hvd-model`` checker comes with item 15.
"""

from . import journal_spec, lease_spec, migration_spec  # noqa: F401
