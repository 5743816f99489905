"""nn.Modules of the port (NCHW inside, reference state_dict names)."""
