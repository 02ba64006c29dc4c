"""Host ms of a run_sweep call (packing, launch, unpacking): its wall less
the TLB kernel's device time."""
from perfbench.harness.readers import TLB_KERNEL, host_ms_per_call

read = host_ms_per_call(TLB_KERNEL)
