"""Command-line launchers of the port (``block``, ``train``) and their
inputs (``specs``)."""
