"""Plain PyTorch references of the cells the configurations run, one file
per cell kind, found by the kind's name. Each imports nothing of the
program."""
