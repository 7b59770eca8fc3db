"""Multi-process region sharding for the port (``distributed``)."""
