"""Distribution: meshes and their axis conventions (``mesh``), the
per-architecture partition rules (``sharding``) and the activation-sharding
context model code reads (``context``) — the JAX package's
``distributed/`` on ``torch.distributed``'s ``DeviceMesh`` and DTensor."""
