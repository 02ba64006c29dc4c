"""Share of the traced window with no kernel on the device, %."""
from perfbench.harness.readers import device_idle_pct as read  # noqa: F401
