# Launchers: ``serve`` (the streams and LM serving CLI), ``analytic`` (the
# planner's per-layer cost view), ``train`` (LM training in the
# fault-tolerant loop) and ``supervisor`` (restart on failure). The mesh,
# multi-host and dry-run launchers wait for the ``dist`` port.
