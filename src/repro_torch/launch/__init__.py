# Launchers: ``serve`` (the streams and LM serving CLI), ``analytic`` (the
# planner's per-layer cost view), ``train`` (LM training in the
# fault-tolerant loop), ``supervisor`` (restart on failure), ``mesh`` and
# ``distributed`` (meshes and the multi-process group), and the dry run:
# ``dryrun`` (the production meshes' cells on meta tensors), ``specs`` (the
# cells) and ``roofline`` (their terms).
