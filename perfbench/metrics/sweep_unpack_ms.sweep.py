"""Host ms of the program's span ``sweep.unpack`` a run_sweep call: the
SimResults built from the copied counters."""
from perfbench.harness.span_readers import span_ms_per_call

read = span_ms_per_call("sweep.unpack")
