from .registry import (ARCH_IDS, SHAPES, ShapeSpec, all_cells, cell_status,
                       get_config)
