"""Launchers: grid construction and the serving entry point."""
