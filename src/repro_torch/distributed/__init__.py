"""Logical-axis sharding rules and collectives on a process mesh
(``sharding``, ``collectives``)."""
