"""Tools of the port, each run as ``python -m m3f_torch.scripts.<name>``."""
