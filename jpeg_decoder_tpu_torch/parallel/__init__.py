"""Device-entropy batch decode (``sharded.py``) on one GPU or over a
``('data', 'seg')`` mesh of ranks (``mesh.py``, ``multihost.py``: one
process per GPU, ``torch.distributed``)."""
