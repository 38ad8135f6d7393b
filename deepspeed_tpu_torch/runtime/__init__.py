"""Training runtime of the port: config, engine and their helpers."""
