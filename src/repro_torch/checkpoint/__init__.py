from .checkpointer import Checkpointer
