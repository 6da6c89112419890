"""Control-plane protocol specs and the ``hvd-model`` explicit-state
checker (port of ``horovod_tpu/analysis/protocol/``).

:mod:`journal_spec` is the HA journal's pure state machine, which
``runner/journal.py`` executes; :mod:`migration_spec` KV-cache live
migration's, which ``serving/kv_cache.py`` and ``serving/migration.py``
execute; :mod:`lease_spec` the fleet lease's, which ``fleet/ledger.py``
executes. :mod:`model` is the BFS explorer, :mod:`machines` builds the
three protocol models over these same functions (plus their seeded-bug
mutants), and :mod:`cli` is ``hvd-model``
(``python -m horovod_tpu_torch.analysis.protocol.cli``).

The spec modules are stdlib-pure: importing them from the runtime loads
no parser stack and no simulator.
"""

from . import journal_spec, lease_spec, migration_spec  # noqa: F401
