"""Data ingest of the port: NIfTI reading and the u2 volume transform."""
