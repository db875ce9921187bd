"""Model modules of the port, named after the reference state_dict keys."""
