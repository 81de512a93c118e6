"""The drivers that run a configuration's cells, one file each, found by
the name a configuration's ``driver`` key gives."""
