"""Elastic capacity transfer: the broker that moves ranks between the
training ``elastic`` group and the serving ``fleet`` group as the traffic
moves.  See :mod:`.capacity`."""

from .capacity import (CONVERSION_STEPS, CapacityBroker, CapacityFloorError,
                       CapacityProtocolError, LocalTrainGroup)

__all__ = ["CONVERSION_STEPS", "CapacityBroker", "CapacityFloorError",
           "CapacityProtocolError", "LocalTrainGroup"]
