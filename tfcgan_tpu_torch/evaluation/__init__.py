"""Evaluation of the port: the serve metric suite and image I/O."""
