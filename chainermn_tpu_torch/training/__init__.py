"""The training loop: ``Trainer`` → ``StandardUpdater`` →
``Optimizer.update``."""

from . import triggers
from .trainer import (PRIORITY_EDITOR, PRIORITY_READER, PRIORITY_WRITER,
                      Trainer)
from .updaters import StandardUpdater, Updater

__all__ = ["Trainer", "Updater", "StandardUpdater", "triggers",
           "PRIORITY_WRITER", "PRIORITY_EDITOR", "PRIORITY_READER"]
