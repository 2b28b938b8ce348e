"""Launchers: the demo world (``world.build_world``) and the serving entry
point (``python -m repro_torch.launch.serve``)."""
