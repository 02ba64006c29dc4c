"""Paged decode serving on the port: continuous batching over the buddy
paged KV cache, class-k coalesced attention on the card."""
from .engine import EngineConfig, Request, ServingEngine
from .scheduler import KVScheduler
