"""Serving helpers of the port: the slot scheduler the streaming engine
runs on (``scheduler``)."""
