"""Data pipeline of the port (``pipeline``)."""
