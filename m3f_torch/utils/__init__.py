"""utils of the port (see the package docstring)."""
