"""Parameters from numpy: the JAX package's tree (or
:func:`.common.init_params_numpy`'s) as the port's tensors.

Both packages keep one layout (nested dicts, block leaves stacked over
layers, ``[d_in, d_out]`` matrices), so conversion is leaf for leaf: the
port then computes the same function on the same numbers.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .common import tree_map


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:            # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) →
    the same nested dict of tensors on ``device``, dtypes kept."""
    return tree_map(lambda a: _leaf(a, device), tree)
