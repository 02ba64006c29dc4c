"""Single source of truth for every packed plane / record layout.

A copy of the JAX package's ``core/plane_layout.py`` (the two must stay
equal; ``tests/test_torch_core.py`` pins it).  Every TLB structure the
lane program carries is a packed int32 array whose trailing axis is a
fixed field tuple; :mod:`repro_torch.core.lane_program`, the plain
executor derive their widths and field indices from this table; the
CUDA kernel (``kernels/tlb_sweep/csrc/tlb_sweep.cu``) spells them as
``#define``s that ``tests/test_torch_core.py`` holds against it.

Layout invariant: every plane carries the ASID its entry was filled
under, and ``asid`` is the LAST field except for declared sidecar
fields (see ``SIDECAR_FIELDS``) — probes require an ASID match and the
context-switch pass clears by it, so a plane without a trailing ASID
cannot participate in multi-tenant worlds.
"""

# Packed planes: name -> trailing-axis field tuple.
PLANE_FIELDS = {
    # L1 / gated 2MB L1 array: 4KB (resp. 2MB) translations.
    "l1": ("tag", "ppn", "lru", "asid"),
    "l1h": ("tag", "ppn", "lru", "asid"),
    # Unified L2: every kind's entries share this layout.  ``aux`` is a
    # per-kind sidecar (subregion contiguity bitmap; 0 for other kinds).
    "l2": ("tag", "kcls", "contig", "ppn", "lru", "asid", "aux"),
    # RMM range table.
    "rmm": ("start", "len", "ppn", "lru", "asid"),
    # Clustered side-TLB.
    "clus": ("tag", "bitmap", "lru", "asid"),
    # Cache-backed tier (Victima lineage).
    "ctlb": ("tag", "ppn", "lru", "asid"),
}

# Fields allowed to follow ``asid`` (per-kind sidecar data).
SIDECAR_FIELDS = ("aux",)

# Precomputed per-vpn records gathered by the step (one row per page).
MAP_REC_FIELDS = ("ppn", "run_start", "run_len", "run_start_ppn")
FILL_REC_FIELDS = ("tag", "k", "contig", "ppn", "aux")

# Per-lane misc scalars (kept in the CUDA kernel's shared memory).
MISC_FIELDS = ("t", "pred", "asid")

# Derived widths.
PLANE_WIDTH = {name: len(fields) for name, fields in PLANE_FIELDS.items()}
MAP_REC_WIDTH = len(MAP_REC_FIELDS)
FILL_REC_WIDTH = len(FILL_REC_FIELDS)
MISC_WIDTH = len(MISC_FIELDS)
