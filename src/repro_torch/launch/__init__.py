"""Entry points of the port (``python -m repro_torch.launch.solve``,
``python -m repro_torch.launch.train``)."""
