from .optimizer import (AdamState, FactorState, OptConfig, abstract_opt,
                        apply_opt, clip_by_global_norm, global_norm, init_opt,
                        opt_logical, schedule)
