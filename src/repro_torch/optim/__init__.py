from .optimizer import (AdamState, FactorState, OptConfig, apply_opt,
                        clip_by_global_norm, global_norm, init_opt, schedule)
