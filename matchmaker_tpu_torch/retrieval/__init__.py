"""Retrieval of the port: corpus encoding, the flat index, batch search."""
