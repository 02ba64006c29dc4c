"""Launch helpers of the port: device meshes over the current process
group (:mod:`.mesh`) and the dry-run's per-cell policy and analytic
memory model (:mod:`.dryrun`; the JAX package's HLO lowering and
analysis have no counterpart here, ``docs/port.md``)."""
