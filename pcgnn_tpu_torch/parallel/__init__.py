"""Multi-device training: the rank mesh (``mesh``), the process group
(``distributed``) and the sharded PC-GNN and baseline steps (``spmd``).

Importing this package imports no submodule."""
