"""Mesh placement and collectives of the port (``sharding.py``)."""
