"""The benchmark's general code: cell lookup, module discovery by name,
profiler reduction, the readers per-layer metrics share, published peaks
and the result line."""
