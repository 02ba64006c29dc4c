from .registry import ARCH_IDS, NOT_PORTED, get_config
