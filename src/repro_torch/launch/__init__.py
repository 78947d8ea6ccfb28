"""Launchers of the port (run with ``python -m repro_torch.launch.<name>``)."""
