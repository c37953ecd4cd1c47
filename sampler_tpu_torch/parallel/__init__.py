"""Chain and graph sharding over torch.distributed: ``comm`` (the mesh and
its collectives), ``launch`` (the ranks), ``chains``, ``graph_shard`` and
``multihost``."""
