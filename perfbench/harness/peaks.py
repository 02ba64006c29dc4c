"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, and the Hopper whitepaper), at the card's
full power limit of 700 W.  Every roofline and ``mfu`` share is taken
against these, with the card's name and power limit printed beside the
run."""

#: dense bf16 tensor-core rate, FLOP/s
BF16_FLOP_PER_S = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: int32 operations each SM issues per clock (four partitions of 16
#: INT32 units, Hopper whitepaper)
INT32_OPS_PER_SM_CLOCK = 64
#: SMs of the H100 SXM and its highest (boost) SM clock, Hz
SMS = 132
SM_CLOCK_HZ = 1.98e9
#: peak int32 operations per second
INT32_OPS_PER_S = INT32_OPS_PER_SM_CLOCK * SMS * SM_CLOCK_HZ
