"""Data loading of the port: synthetic batches and paired PNG datasets."""
