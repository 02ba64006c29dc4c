"""The TLB-sweep kernel's share of its roofline, %: the least time of
counts/tlb_sweep.py's work over the kernel's device time."""
from perfbench.harness.readers import TLB_KERNEL, roofline

read = roofline("tlb_sweep", TLB_KERNEL)
