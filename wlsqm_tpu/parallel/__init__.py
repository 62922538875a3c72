"""Multi-device data-parallel sharding of the case axis."""
