"""Telemetry of the port: the loop's idle-fraction helper and the
canonical counter keys of the store and the device caches."""
