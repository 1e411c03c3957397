"""Launch tooling: meshes, sharding specs, the world of ranks a mesh runs
on, and the serving CLI (``python -m repro_torch.launch.serve``)."""
