"""Static analysis (port of ``horovod_tpu/analysis/``), in part.

Only what the redistribution planner prices its programs with is here:
``costmodel.collective_time`` and the cold-case α–β table. The linters,
the schedule verifier, the symbolic simulator (``hvd-sim``, which
``resharding.Program.prove`` needs), calibration and the HVD6xx
diagnostics come with ROADMAP item 15.
"""
