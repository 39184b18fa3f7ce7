"""Plain references of the configurations' models."""
