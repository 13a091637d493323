"""Telemetry of the port: for now only the loop's idle-fraction helper."""
