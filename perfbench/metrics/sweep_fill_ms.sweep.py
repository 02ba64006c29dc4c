"""Host ms of the program's span ``sweep.pack.fills`` a run_sweep call:
every fill profile of the batch."""
from perfbench.harness.span_readers import span_ms_per_call

read = span_ms_per_call("sweep.pack.fills")
