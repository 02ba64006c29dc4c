"""The port's distributed layer: the logical sharding rules as DTensor
placements (:mod:`.sharding`), the int8 error-feedback all-reduce
(:mod:`.grad_compress`) and GPipe over a mesh axis (:mod:`.pipeline`).
``torch.distributed`` is imported only by the functions that need it."""
from .sharding import (ACT_RULES, DP, PARAM_RULES, MeshShape, Sharding,
                       act_pspec, dp_axis_names, dp_size, logical_to_placements,
                       logical_to_pspec, mesh_shape, param_sharding,
                       with_logical_constraint)
