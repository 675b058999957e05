"""Launchers of the port: the serving and training drivers."""
