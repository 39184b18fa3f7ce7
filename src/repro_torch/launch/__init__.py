"""Launchers of the port: so far the LM demo (``serve``)."""
