"""Thread-local global configuration (consumed-Chainer surface).

A copy of ``chainermn_tpu.core.config`` (pure host code): ``config.train``
and the other flags, with ``using_config`` to set one for a block.
Arbitrary attributes are allowed for user code parity.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["global_config", "config", "using_config"]


class _GlobalConfig:
    def __init__(self):
        self.train = True
        self.enable_backprop = True
        self.dtype = "float32"
        self.debug = False


global_config = _GlobalConfig()


class _LocalConfig(threading.local):
    def __getattr__(self, name):  # fall through to global defaults
        return getattr(global_config, name)


config = _LocalConfig()


@contextlib.contextmanager
def using_config(name, value, cfg=config):
    if name in cfg.__dict__:
        old = cfg.__dict__[name]
        setattr(cfg, name, value)
        try:
            yield
        finally:
            setattr(cfg, name, old)
    else:
        setattr(cfg, name, value)
        try:
            yield
        finally:
            delattr(cfg, name)
