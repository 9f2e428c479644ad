"""Distributed-execution support of the port (``repro.dist``): logical-axis
sharding rules as DTensor placements over a ``DeviceMesh``, optimizer-state
specs, and pod-scale fault tolerance primitives."""
