"""Hand-written Hopper kernels of the port, each beside its plain version:
``tlb_sweep`` (the batched TLB sweep), ``paged_attention`` (class-k paged
decode attention) and ``flash_attention`` (prefill attention)."""
