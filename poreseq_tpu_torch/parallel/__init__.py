"""Multi-process region sharding (``distributed``) and the device mesh over
one region's events and mutation groups (``mesh``) for the port."""
