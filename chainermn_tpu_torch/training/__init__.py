"""The training loop: ``Trainer`` → ``StandardUpdater`` →
``Optimizer.update``, and its extensions."""

from . import extensions, triggers
from .trainer import (PRIORITY_EDITOR, PRIORITY_READER, PRIORITY_WRITER,
                      Extension, Trainer, make_extension)
from .updaters import StandardUpdater, Updater

__all__ = ["Trainer", "Extension", "make_extension", "Updater",
           "StandardUpdater", "extensions", "triggers", "PRIORITY_WRITER",
           "PRIORITY_EDITOR", "PRIORITY_READER"]
