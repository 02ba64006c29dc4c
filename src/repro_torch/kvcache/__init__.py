"""Paged KV cache bookkeeping (host numpy): the buddy page allocator and the
class-k descriptor tables — copies of the JAX package's ``kvcache``."""
from .allocator import PagedKVAllocator, SeqAlloc
from .block_table import (assign_classes, choose_kernel_classes,
                          descriptor_tables, dma_descriptor_count,
                          window_coverage)
