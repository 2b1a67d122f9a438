"""Several training processes, one per rank: the rank grids and pod meshes
(``mesh``), the placement rules (``sharding``), the collectives
(``comm``), the ZeRO-sharded global step (``zero``), the model axis's
tensor-parallel operations (``tensor_parallel``) and a process launcher for
tests and smoke runs (``spawn``).

Ported from the JAX package's ``launch/mesh.py``, ``distributed/sharding.py``
and ``distributed/zero.py``: where the reference shards arrays over the
devices of one program, the port runs one process per rank over
``torch.distributed``."""
