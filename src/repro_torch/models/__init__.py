"""Model definitions of the port (the CNN topologies)."""
