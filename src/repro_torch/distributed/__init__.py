"""Process-group plumbing for the port's mesh paths (``sharding``)."""
