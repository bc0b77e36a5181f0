"""Measurement harnesses of the port (run on the card; nothing here is
reachable from :mod:`lz4tpu_torch.pipeline`)."""
