"""Host ms of the program's span ``sweep.pack.stack`` a run_sweep call:
the padding and stacking of the record stacks."""
from perfbench.harness.span_readers import span_ms_per_call

read = span_ms_per_call("sweep.pack.stack")
