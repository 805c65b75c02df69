"""Applications of the port: the spatial_test suite (apps/spatial.py)."""
