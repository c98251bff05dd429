"""Model definitions of the port: the CNN topologies and the LM stacks."""
