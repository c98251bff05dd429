"""Mesh construction for the port (the counterpart of ``repro.launch``,
the mesh part only)."""
