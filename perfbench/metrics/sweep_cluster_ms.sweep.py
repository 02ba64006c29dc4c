"""Host ms of the program's span ``sweep.pack.clusters`` a run_sweep
call: every cluster bitmap of the batch."""
from perfbench.harness.span_readers import span_ms_per_call

read = span_ms_per_call("sweep.pack.clusters")
