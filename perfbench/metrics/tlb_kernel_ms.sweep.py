"""Device ms of the TLB-sweep kernel a run_sweep call, from the profiler."""
from perfbench.harness.readers import TLB_KERNEL, kernel_ms_per_call

read = kernel_ms_per_call(TLB_KERNEL)
