"""GB/s of the upload: run_sweep's packed_bytes over the device time of
the copies host to device, summed over the window's calls."""
from perfbench.harness.span_readers import upload_gbps as read  # noqa: F401
