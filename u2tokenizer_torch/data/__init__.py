"""Data of the port: NIfTI reading, the u2 volume transform and the
synthetic report scripts of the speculative benchmark."""
