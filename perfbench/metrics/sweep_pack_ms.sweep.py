"""Host ms of the program's span ``sweep.pack`` a run_sweep call: the
whole of packing (pack_lanes and init_batched_state)."""
from perfbench.harness.span_readers import span_ms_per_call

read = span_ms_per_call("sweep.pack")
