"""Host utilities: the native data-loader core (:mod:`.native`) and the
profiling helpers (:mod:`.profiling`: ``trace``, ``annotate``,
``Profile``, ``device_ops_in_ranges``)."""

from .profiling import Profile, annotate, device_ops_in_ranges, trace

__all__ = ["trace", "annotate", "Profile", "device_ops_in_ranges"]
