"""Device-entropy batch decode (``sharded.py``): one GPU for now; the mesh
(``torch.distributed``, one process per card) is still to port."""
