"""Several training processes, one per rank: the rank grid (``mesh``), the
collectives (``comm``), the ZeRO-sharded global step (``zero``) and a
process launcher for tests and smoke runs (``spawn``).

Ported from the JAX package's ``launch/mesh.py`` and
``distributed/zero.py``: where the reference shards arrays over the devices
of one program, the port runs one process per rank over
``torch.distributed``."""
