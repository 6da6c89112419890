"""Static analysis (port of ``horovod_tpu/analysis/``), in part.

Here: ``costmodel`` (``collective_time`` and the cold-case α–β table the
redistribution planner prices with; the autotuner's warm-start prior
``rank_candidates``), ``protocol/journal_spec`` (the HA journal's state
machine) and ``protocol/migration_spec`` (KV-cache live migration's). The linters, the schedule verifier, the symbolic simulator
(``hvd-sim``, which ``resharding.Program.prove`` needs), calibration, the
HVD6xx diagnostics and the ``hvd-model`` checker come with ROADMAP item 15.
"""
