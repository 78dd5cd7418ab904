"""Distributed optimization of the port: the sampled gradient exchange
(``compression``)."""
