"""The mesh: logical-axis sharding rules (``api``, ``rules``) and the int8
cross-pod gradient all-reduce (``compression``) over ``torch.distributed``."""
