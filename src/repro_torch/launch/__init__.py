# Launchers: ``serve`` (the streams and LM serving CLI) and ``analytic``
# (the planner's per-layer cost view). The mesh, dry-run and training
# launchers wait for the ``dist`` port.
