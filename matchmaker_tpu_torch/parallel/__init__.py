"""More than one device: the mesh (parallel/mesh.py) and the process group
(parallel/multihost.py)."""
