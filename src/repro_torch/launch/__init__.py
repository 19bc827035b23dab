"""Command-line launchers of the port (``python -m
repro_torch.launch.serve``, ``.train``, ``.dryrun``, ``.roofline``), the
production meshes (``mesh``) and the per-device cost counter (``cost``)."""
