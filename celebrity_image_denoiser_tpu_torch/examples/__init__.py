"""Walkthroughs of the port: ``quickstart`` and ``multichip``."""
