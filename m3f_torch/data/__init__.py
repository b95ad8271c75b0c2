"""data of the port (see the package docstring)."""
