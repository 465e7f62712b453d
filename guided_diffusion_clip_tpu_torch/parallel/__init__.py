"""More than one process: the process group (``dist``) and FSDP2's mesh and sharding (``mesh``)."""
