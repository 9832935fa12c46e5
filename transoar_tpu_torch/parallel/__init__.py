"""Multi-GPU training of the port (the JAX package's ``parallel/``):
``mesh.py`` (torchrun's process group, the ``dp x tp`` mesh, the rows each
process loads), ``tp.py`` (Megatron tensor parallelism of the neck) and
``fsdp.py`` (FSDP2 or DDP over dp). A run without torchrun's environment
uses none of it."""
